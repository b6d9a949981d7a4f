"""The ceiling of the DP roofline: the most cells a second the card could
fill at one 32-bit lane operation a cell.

A Gotoh cell needs at least three results (M, Ix, Iy), and even DPX's
paired 16-bit instructions need 1.5 instructions a cell, so no kernel can
reach this ceiling; a share above 100% means the cells are counted too
high or the time leaves work out.  The input bytes (letters in, lines
out) set a far lower bound than this, so the ceiling is the compute one.
"""

from __future__ import annotations

import subprocess

# CUDA C Programming Guide, "Arithmetic Instructions", compute capability
# 9.0: 64 results a clock an SM for 32-bit integer add, min and max.
INT32_LANE_OPS_PER_CLOCK_PER_SM = 64
# NVIDIA H100 SXM5's maximum SM clock (it has 132 SMs).
H100_SXM_MAX_SM_MHZ = 1980


def card() -> dict:
    """The card's SM count and maximum SM clock, as the card reports them
    (the H100 SXM clock where it cannot be read)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = H100_SXM_MAX_SM_MHZ
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.split()
        mhz = int(float(out[0]))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"sms": sms, "max_sm_mhz": mhz}


def ceiling_cells_per_s(sms: int, max_sm_mhz: int) -> float:
    return sms * INT32_LANE_OPS_PER_CLOCK_PER_SM * max_sm_mhz * 1e6

"""Probes of the card's best case for the kernels' work (``csrc/probes/peaks.cu``).

Measurement only: nothing of the package's paths calls this module.
``chip_smoke.py`` runs the probes and divides each kernel's work by what
they measure to get the kernel's bound:

  * :func:`cells` — a Gotoh fill in registers at the fewest int32
    operations a cell needs on sm_90 (``CELL_OPS``), so a launch that fills
    the card gives the peak cell rate of a fill's arithmetic;
  * :func:`addmin` — chains of the DPX fused add-min, for its issue rate;
  * :func:`chase` — one thread's dependent loads, for their latency from
    L1 or L2; :func:`chase_smem` the same from shared memory.

The probes take CUDA tensors only: there is no plain version of a rate.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC_DIR / "probes" / "peaks.cu"
COLS = 8  # columns a probe thread fills
CELL_OPS = {"cost": 9, "moves": 23}  # int32 operations a cell (source note)

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
_SIGNATURES = {
    # sub8 d8 icost go m T moves out stream
    "peak_cells_launch": ([_PTR] * 3 + [_I32] * 4 + [_PTR, _PTR], _I32),
    # blocks threads y z iters out stream
    "peak_addmin_launch": ([_I32] * 5 + [_PTR, _PTR], _I32),
    # next start warm steps out stream
    "peak_chase_launch": ([_PTR] + [_I32] * 3 + [_PTR, _PTR], _I32),
    # next count start warm steps out stream
    "peak_chase_smem_launch": ([_PTR] + [_I32] * 4 + [_PTR, _PTR], _I32),
    "peak_error_string": ([_I32], ctypes.c_char_p),
}
_lock = threading.Lock()
_lib = None


def load():
    """The bound probe library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_build.build([SOURCE])[0]))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _launch(name: str, device: torch.device, *args) -> None:
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.peak_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def cells(sub8, d8, icost, gap_open: int, rows: int, *, moves: bool):
    """Thread t fills the pair (a_t repeated ``rows`` times, b_t1..b_t8).

    ``sub8`` / ``d8``: (T, 8) int32 CUDA tensors, cost(a_t, b_tc) and
    dcost(b_tc); ``icost``: (T,) icost(a_t).  Returns (T, 4) int32:
    final3 and, with ``moves``, the hash h = 31 h + code over the codes of
    rows 1.., columns 1..8 in row-major order (uint32, wrapping).
    """
    T = sub8.shape[0]
    out = torch.empty((T, 4), dtype=torch.int32, device=sub8.device)
    _launch("peak_cells_launch", sub8.device, sub8.data_ptr(), d8.data_ptr(),
            icost.data_ptr(), int(gap_open), int(rows), T, int(moves),
            out.data_ptr())
    return out


def addmin(device, blocks: int, threads: int, iters: int) -> torch.Tensor:
    """``blocks x threads`` threads, 8 chains of ``iters`` fused add-mins."""
    out = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    _launch("peak_addmin_launch", torch.device(device), blocks, threads, -1,
            1 << 20, iters, out.data_ptr())
    return out


def chase(next_idx: torch.Tensor, warm: int, steps: int) -> torch.Tensor:
    """One thread follows k = next_idx[k] from 0: ``warm`` untimed steps,
    then ``steps`` timed; returns (2,) int64 (clocks, index reached)."""
    out = torch.empty(2, dtype=torch.int64, device=next_idx.device)
    _launch("peak_chase_launch", next_idx.device, next_idx.data_ptr(), 0,
            int(warm), int(steps), out.data_ptr())
    return out


def chase_smem(next_idx: torch.Tensor, warm: int, steps: int) -> torch.Tensor:
    """:func:`chase` over a copy of ``next_idx`` (at most 12 288 ints) in
    shared memory."""
    out = torch.empty(2, dtype=torch.int64, device=next_idx.device)
    _launch("peak_chase_smem_launch", next_idx.device, next_idx.data_ptr(),
            next_idx.numel(), 0, int(warm), int(steps), out.data_ptr())
    return out


def _ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` on the card over ``reps`` runs after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _cycle(device, count: int, stride: int, gen: torch.Generator) -> torch.Tensor:
    """next_idx over ``count`` slots ``stride`` ints apart, one random cycle
    through all of them starting at slot 0."""
    order = torch.randperm(count - 1, generator=gen) + 1
    order = torch.cat([torch.zeros(1, dtype=torch.int64), order]) * stride
    nxt = torch.zeros(count * stride, dtype=torch.int32)
    nxt[order] = torch.roll(order, -1).to(torch.int32)
    return nxt.to(device)


def _inputs(T: int, cost_mat: torch.Tensor, gap_id: int,
            gen: torch.Generator):
    """Random (a_t, b_t1..b_t8) over the table's letters, and the probe's
    arguments for them: sub8, d8, icost (CPU)."""
    letters = torch.tensor(
        [c for c in range(cost_mat.shape[0]) if c != gap_id]
    )
    a = letters[torch.randint(len(letters), (T,), generator=gen)]
    b = letters[torch.randint(len(letters), (T, COLS), generator=gen)]
    sub8 = cost_mat[a[:, None], b].contiguous()
    d8 = cost_mat[gap_id, b].contiguous()
    icost = cost_mat[a, gap_id].contiguous()
    return a, b, sub8, d8, icost


def check(device, cost_mat: torch.Tensor, gap_id: int, gap_open: int,
          seed: int, pairs: int = 64, rows: int = 96) -> None:
    """Raise unless the cell probe, cost only and with codes, gives the
    plain row scan's final3 and codes on ``pairs`` random pairs of
    ``rows`` x 8 (``cost_mat`` a CPU (A, A) int32 table)."""
    from ..ops.fill_rows import row_fill

    cost_mat = cost_mat.to(torch.int32)
    gen = torch.Generator().manual_seed(seed)
    a, b, sub8, d8, icost = _inputs(pairs, cost_mat, gap_id, gen)
    on = [x.to(device) for x in (sub8, d8, icost)]
    got_cost = cells(*on, gap_open, rows, moves=False).cpu()
    got_moves = cells(*on, gap_open, rows, moves=True).cpu()
    for t in range(pairs):
        ta = torch.full((rows + 1,), int(a[t]), dtype=torch.int32)
        tb = torch.cat([torch.zeros(1, dtype=torch.int64), b[t]]).to(torch.int32)
        want = row_fill(ta, tb, cost_mat, gap_id, gap_open)
        h = 0
        for code in want.moves[1:, 1:].reshape(-1).tolist():
            h = (h * 31 + code) & 0xFFFFFFFF
        h = h - (1 << 32) if h >= 1 << 31 else h
        if not (torch.equal(got_cost[t, :3], want.final3)
                and torch.equal(got_moves[t, :3], want.final3)
                and int(got_moves[t, 3]) == h):
            raise RuntimeError(f"the cell probe disagrees with the row scan "
                               f"on pair {t}")


def measure(device, cost_mat: torch.Tensor, gap_id: int, gap_open: int,
            seed: int) -> dict:
    """:func:`check` the cell probe, then measure on a launch that fills
    the card.

    Returns the cell rates (cells/s), cost only and with codes; the DPX
    fused add-min's rate (operations/s); and the clocks of one dependent
    load from L1, from L2 and from shared memory.
    """
    device = torch.device(device)
    check(device, cost_mat, gap_id, gap_open, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    T, rows = sms * 2048, 1024
    on = [x.to(device)
          for x in _inputs(T, cost_mat.to(torch.int32), gap_id, gen)[2:]]
    n_cells = T * rows * COLS
    out = {}
    for mode in ("cost", "moves"):
        ms = _ms(lambda: cells(*on, gap_open, rows, moves=mode == "moves"), 5)
        out[f"{mode}_cells_s"] = n_cells / (ms * 1e-3)
    blocks, threads, iters = sms * 8, 256, 4096
    ms = _ms(lambda: addmin(device, blocks, threads, iters), 5)
    out["addmin_ops_s"] = blocks * threads * 8 * iters / (ms * 1e-3)
    for level, count, stride in (("l1", 64, 32), ("l2", 1 << 17, 32)):
        nxt = _cycle(device, count, stride, gen)
        steps = max(count, 8192)
        clocks = int(chase(nxt, count, steps)[0])
        out[f"{level}_load_clocks"] = clocks / steps
    nxt = _cycle(device, 1024, 1, gen)
    out["smem_load_clocks"] = int(chase_smem(nxt, 1024, 8192)[0]) / 8192
    return out

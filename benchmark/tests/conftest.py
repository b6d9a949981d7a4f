"""Shared pieces of the benchmark's own tests: tiny traffic for CPU runs."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = [cell["name"] for cell in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

# Each cell's traffic at a size the CPU engine runs in a second; the batch
# cells' reservoir holds every answer of such a run, so that a fault in one
# answer a call always shows.
TINY = {
    "align_pairs": dict(pairs_per_call=6, pool_calls=3, warmup_calls=1,
                        trace_calls=2, sample={"reservoir": 4096}),
    "find_global_alignment": dict(pool_calls=4, warmup_calls=1, trace_calls=2,
                                  sample={"reservoir": 3}),
}


def tiny_traffic(cell: str, mix: str | None = None) -> dict:
    """The cell's traffic, or the mix ``traffic/<mix>.json`` in its place,
    at a size the CPU runs."""
    from benchmark.harness import core

    _, _, traffic, _ = core.cell_parts(cell)
    if mix is not None:
        traffic = json.loads((core.BENCH / "traffic" / f"{mix}.json").read_text())
    out = {**traffic, **TINY[traffic["driver"]]}
    if "fixed" in traffic["length"]:
        out["length"] = {"fixed": 30}
        if "count" in traffic["edits"]:
            out["edits"] = {"count": 3}
    else:
        out["length"] = {**traffic["length"], "lognormal": {
            **traffic["length"]["lognormal"], "median": 20, "min": 5, "max": 60}}
    return out


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

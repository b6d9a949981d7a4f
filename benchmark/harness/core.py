"""One run of one cell: set-up, the measured window, the judge and the
result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json``, ``traffic/<traffic>.json``, the driver the
traffic file names (``drivers/<driver>.py``) and one reader a metric
(``metrics/<metric>.py``).  The drivers take the program as ``ctx.port``,
so a test can put a broken program in its place.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import judge, trace
from . import traffic as traffic_mod

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "globalign_tpu", "globalign")


@dataclass
class Record:
    """One call (batch cells) or request (single pairs) of the window."""

    pairs: int
    cells: int
    seconds: float
    ok: bool
    phases: dict | None = None
    in_window: bool = True
    in_slice: bool = False


@dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    port: object
    pool: list = field(default_factory=list)
    sample: object = None


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    records: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    slice: trace.Slice | None = None
    ceiling: float | None = None


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(name: str, traffic: dict | None = None):
    """(cell, config, traffic, metric specs by kind) of the cell ``name``."""
    spec = manifest()
    cell = next(c for c in spec["workloads"] if c["name"] == name)
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / config_entry["file"]).read_text())
    if traffic is None:
        traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cell, config, traffic, {"end_to_end": mine(spec["end_to_end"]),
                                   "per_layer": mine(spec["per_layer"])}


def driver(traffic: dict):
    return load_module(BENCH / "drivers" / f"{traffic['driver']}.py")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare(ctx: Context):
    """The cell's pool from the seed, and the driver's warm-up."""
    t0 = time.perf_counter()
    ctx.pool = traffic_mod.generate(ctx.traffic, ctx.config["letters"], ctx.seed)
    ctx.sample = judge.Sample(ctx.traffic, ctx.seed)
    t1 = time.perf_counter()
    drive = driver(ctx.traffic)
    drive.warm_up(ctx)
    gc.collect()
    gc.freeze()
    print(f"set-up: pool {t1 - t0:.3f} s, warm-up {time.perf_counter() - t1:.3f} s",
          file=sys.stderr)
    return drive


def read_metrics(specs: list[dict], run: Run) -> dict:
    out = {}
    for spec in specs:
        value = load_module(BENCH / "metrics" / f"{spec['name']}.py").read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *,
             t_start: float, device: str = "cuda", port=None,
             traffic: dict | None = None) -> tuple[int, dict | None]:
    """Run the cell once; returns (exit code, result line or None)."""
    import torch

    cell, config, traffic, specs = cell_parts(name, traffic)
    if port is None:
        import globalign_tpu_torch as port
    print(f"set-up: imports {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    ctx = Context(cell, config, traffic, seed, seconds, trace_on, device, port)
    drive = prepare(ctx)
    run = Run(setup_s=time.perf_counter() - t_start)
    drive.window(ctx, run)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ctx.pool = None
        gc.collect()
        torch.cuda.empty_cache()
    else:
        peak = 0

    t0 = time.perf_counter()
    checks = judge.judge(run.answers, run.records, config, device,
                         with_lines=traffic.get("with_traceback", True))
    print(f"reference: {time.perf_counter() - t0:.3f} s for "
          f"{checks['compared']['value']} answers", file=sys.stderr)

    if trace_on and run.slice is not None and on_card:
        from . import peaks

        found = peaks.card()
        run.ceiling = peaks.ceiling_cells_per_s(found["sms"], found["max_sm_mhz"])
        print(f"ceiling: {found['sms']} SMs x {peaks.INT32_LANE_OPS_PER_CLOCK_PER_SM}"
              f" x {found['max_sm_mhz']} MHz = {run.ceiling:.4e} cells/s",
              file=sys.stderr)
    metrics = read_metrics(specs["per_layer" if trace_on else "end_to_end"], run)

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3, None

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace_on and run.slice is not None:
        dev["busy_s"] = trace.busy_s(run.slice)
        dev["window_s"] = trace.window_s(run.slice)
    result = {
        "correct": judge.passed(checks),
        "attempted": sum(r.pairs for r in run.records),
        "failed": sum(r.pairs for r in run.records if not r.ok),
        "metrics": metrics,
        "device": dev,
    }
    if trace_on and run.slice is not None:
        result["breakdown"] = trace.breakdown(run.slice)
    result["checks"] = checks
    return 0, result

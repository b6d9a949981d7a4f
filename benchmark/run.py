"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic and metrics are named in
``BENCHMARK.json`` at the root of the checkout.  The program under test is
``globalign_tpu_torch`` from the checkout; the run needs a CUDA card and
fails, printing no result, without one.  The last line of standard output
is one JSON object; the numbers that decide ``correct`` are the last lines
of standard error and the result's last key, ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from benchmark.harness import core, judge

    cell = next((c for c in core.manifest()["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        print(f"no cell named {args.workload}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.cuda.init()

    code, result = core.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=T_START)
    if result is None:
        return code
    print(judge.report(result["checks"]), file=sys.stderr)
    print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())

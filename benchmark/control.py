"""The control's readings, which set the upper end of ``correct``'s limits.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 8

For each seed the cell runs as ``run.py`` runs it (set-up, a window of
``--seconds`` at the cell's own sizes, the sampled answers judged against
the reference), with the control in the program's place: the plain
reference with linear gaps, a gap priced without its open cost, which
breaks the configurations' affine costs.  The control serves each call in
the window, so the warm-up is one call.  One JSON line a seed; the
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import core, judge  # noqa: E402


class Control:
    """The control in the program's place, with the entries the drivers
    call."""

    def __init__(self, cell: str, device: str = "cuda"):
        _, self.config, traffic, _ = core.cell_parts(cell)
        self.device, self.lines = device, traffic.get("with_traceback", True)

    def resolve_scheme(self, *args, **options):
        return None

    def _answers(self, pairs):
        got = judge.reference(pairs, self.config, self.device, self.lines,
                              linear_gaps=True)
        return [SimpleNamespace(cost=c, score=s, seq_1_aligned=a, middle_part=b,
                                seq_2_aligned=d) for c, s, a, b, d in
                (got[p] for p in pairs)]

    def align_pairs(self, pairs, flush=True, **options):
        out = self._answers(list(pairs))
        return out if flush else SimpleNamespace(resolve=lambda: out)

    def find_global_alignment(self, seq_1, seq_2, **options):
        return self._answers([(seq_1, seq_2)])[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The control's readings.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, _, traffic, _ = core.cell_parts(args.workload)
    traffic = {**traffic, "warmup_calls": 1}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        code, result = core.run_cell(args.workload, seed, args.seconds, False,
                                     t_start=t0, port=Control(args.workload),
                                     traffic=traffic)
        if result is None:
            return code
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the wave kernel against the row split on a CUDA card.

For seeded DNA pairs of m x n (seq_2 a ~85%-identity relative of seq_1,
the default DNA scheme: the JAX bench's wave arm), it times
``fill_wave.wave_frontiers`` and the row split
(``fill_split.split_fill_cost``) with CUDA events, in turns (wave, split,
split, wave), each turn the mean of ``--reps`` calls after a warm-up, and
with ``--check-plain`` holds the kernel's captures against the plain
version's on the card.  It prints one JSON line a shape, beside the card's
name and power limit::

    python globalign_tpu_torch/time_wave.py --shapes 10000x10000 50000x128
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 8


def dna_pair(rng, m: int, n: int) -> tuple[str, str]:
    """seq_1 of m random bases; seq_2 a ~85%-identity relative cut or
    extended to n."""
    letters = np.array(list("ACGT"))
    a = rng.integers(0, 4, m)
    b = a.copy()
    sub = rng.random(m) < 0.09
    b[sub] = (b[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    b = b[rng.random(m) >= 0.03]
    ins = np.flatnonzero(rng.random(len(b)) < 0.03)
    b = np.insert(b, ins, rng.integers(0, 4, len(ins)))
    b = np.concatenate([b, rng.integers(0, 4, max(0, n - len(b)))])[:n]
    return "".join(letters[a]), "".join(letters[b])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", nargs="+", default=["10000x10000", "50000x50000"])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--check-plain", action="store_true",
                        help="also hold the kernel against the plain version")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_wave: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from globalign_tpu_torch import resolve_scheme
    from globalign_tpu_torch.models.gotoh import GotohAligner
    from globalign_tpu_torch.ops import fill_split, fill_wave

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(SEED)

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    for shape in args.shapes:
        m, n = (int(x) for x in shape.split("x"))
        s1, s2 = dna_pair(rng, m, n)
        aligner = GotohAligner(resolve_scheme(s1, s2), device="cuda")
        prm = fill_wave.uniform_scheme_params(aligner.scheme.costing.values,
                                              aligner.gap_id)
        ta, tb = aligner._encode(s1), aligner._encode(s2)
        enc = (ta, tb, *prm, aligner.gap_open, m, n)
        got = fill_wave.wave_frontiers(*enc)
        plain_ok = None
        if args.check_plain:
            plain_ok = bool(torch.equal(got, fill_wave._plain(*enc)))
            if not plain_ok:
                raise SystemExit(f"time_wave: kernel != plain at {shape}")
        split = (ta, tb, aligner.cost_mat, aligner.gap_id, aligner.gap_open)
        arms = {
            "wave": lambda: fill_wave.wave_frontiers(*enc),
            "row split": lambda: fill_split.split_fill_cost(*split),
        }
        times = {name: [] for name in arms}
        for name in ("wave", "row split", "row split", "wave"):
            times[name].append(cuda_ms(arms[name]))
        print(json.dumps({
            "card": card, "shape": shape, "reps": args.reps, "ms": times,
            "plain_equal": plain_ok, "tiles": fill_wave.plan(m, n).tiles,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

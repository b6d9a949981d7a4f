"""Time ``align_pairs`` on a seeded 1024-pair DNA chunk on a CUDA card.

The chunk has the shape of the batch runner's default chunk: lengths
819-1024, each drawn on its own, seq_2 a ~85%-identity relative of seq_1.
For cost-only and traceback calls, unsharded and then over an NCCL world
of one (``parallel.make_pair_mesh``, set up after the unsharded arms), it
prints one JSON line: per arm the median,
least and greatest over 7 calls (after one warm-up) of the
end-to-end time (host clock around a synchronised call), of each of
``align_pairs``' host phases (``phase_seconds``, whatever phases the
checkout's ``align_pairs`` records; a phase a call lacks counts 0), of
their sum and of the rest of the end-to-end time (``unphased``), in ms,
beside the card's name and power limit.

``--root DIR`` imports ``globalign_tpu_torch`` from the checkout at DIR
(default: the one that holds this file), so two checkouts are compared on
one card, each in its own process, alternating::

    python globalign_tpu_torch/time_serving.py --root build/parent
    python globalign_tpu_torch/time_serving.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPS = 7
SEED = 0


def dna_chunk(seed: int, count: int = 1024, lo: int = 819, hi: int = 1024):
    """``count`` DNA pairs: seq_2 is seq_1 with ~9% substitutions and ~3%
    each of deletions and insertions, cut or extended to its own length."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ACGT"))
    pairs = []
    for _ in range(count):
        m, n = (int(x) for x in rng.integers(lo, hi + 1, 2))
        a = rng.integers(0, 4, m)
        b = a.copy()
        sub = rng.random(m) < 0.09
        b[sub] = (b[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        b = b[rng.random(m) >= 0.03]
        ins = np.flatnonzero(rng.random(len(b)) < 0.03)
        b = np.insert(b, ins, rng.integers(0, 4, len(ins)))
        b = np.concatenate([b, rng.integers(0, 4, max(0, n - len(b)))])[:n]
        pairs.append(("".join(letters[a]), "".join(letters[b])))
    return pairs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="checkout to import globalign_tpu_torch from")
    args = parser.parse_args(argv)

    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(here)]
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_serving: no CUDA card", file=sys.stderr)
        return 1

    import globalign_tpu_torch
    from globalign_tpu_torch import align_pairs, resolve_scheme
    from globalign_tpu_torch.parallel import make_pair_mesh, multihost

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    pairs = dna_chunk(SEED)
    scheme = resolve_scheme("".join(a for a, _ in pairs), "".join(b for _, b in pairs))

    def world_of_one():  # after the unsharded arms: NCCL's threads start here
        multihost.initialize(num_processes=1)
        return make_pair_mesh()

    arms = {}
    for mesh_name, make_mesh in (("unsharded", lambda: None),
                                 ("world of one", world_of_one)):
        mesh = make_mesh()
        for with_tb in (False, True):
            def call(phases=None):
                return align_pairs(pairs, scheme=scheme, with_traceback=with_tb,
                                   mesh=mesh, phase_seconds=phases)

            call()  # warm-up: builds the kernels, fills the caches
            rows = []
            for _ in range(REPS):
                phases = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(phases)
                torch.cuda.synchronize()
                e2e = 1e3 * (time.perf_counter() - t0)
                phase_ms = {k: 1e3 * v for k, v in phases.items()}
                rows.append(dict(e2e=e2e, **phase_ms,
                                 phases=sum(phase_ms.values()),
                                 unphased=e2e - sum(phase_ms.values())))
            names = list(dict.fromkeys(k for row in rows for k in row))
            cols = {k: [row.get(k, 0.0) for row in rows] for k in names}
            arms[f"{mesh_name}, {'traceback' if with_tb else 'cost'}"] = {
                k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
                for k, v in cols.items()
            }
    torch.distributed.destroy_process_group()
    print(json.dumps({
        "root": str(Path(globalign_tpu_torch.__file__).resolve().parents[1]),
        "card": card, "reps": REPS, "seed": SEED, "arms": arms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time ``gotoh_tile`` builds against each other and ``gotoh_fill`` on a card.

For each source (the package's ``csrc/gotoh_tile.cu`` by default, or the
given copies: an older checkout's, an edited one), built by ``nvcc`` like
the package's and bound in its place, it times with CUDA events, in turns
(the sources in order, then reversed), each turn the mean of ``--reps``
calls after a warm-up, on seeded DNA:

  * a tile's time at every (H, W), with codes and cost only: a pair one
    tile column wide (64 H x 32 W), whose 64 tiles run one after another;
  * the fills of ``--shapes`` (with codes, one pair) at the plan's (H, W);

and ``gotoh_fill`` on the same fills; every build's final3 and codes are
held against ``gotoh_fill``'s (a build without an (H, W) instance gets
null there).  It prints one JSON line beside the card's name and power
limit::

    python globalign_tpu_torch/time_tile.py [--source build/a.cu ...]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SEED = 14


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", nargs="*", default=[],
                        help="other builds of gotoh_tile.cu (default: none)")
    parser.add_argument("--shapes", nargs="*", default=["8000x8000"])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_tile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from globalign_tpu_torch import resolve_scheme
    from globalign_tpu_torch.ops import fill_cuda, fill_tile
    from globalign_tpu_torch.utils import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    package = cuda_build.load()
    sources = [cuda_build.CSRC_DIR / "gotoh_tile.cu"] + [
        Path(s).resolve() for s in args.source]
    libs = {}
    for src, so_path in zip(sources, cuda_build.build(sources)):
        lib = ctypes.CDLL(str(so_path))
        funcs = {}
        for name, (argtypes, restype) in cuda_build.SIGNATURES["gotoh_tile"].items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
            funcs[name] = fn
        libs[str(src)] = SimpleNamespace(**{**vars(package), **funcs})

    @contextlib.contextmanager
    def bound(src):
        real = cuda_build.load
        cuda_build.load = lambda: libs[src]
        try:
            yield
        finally:
            cuda_build.load = real

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    scheme = resolve_scheme("ACGT", "ACGT")
    cost = torch.from_numpy(np.ascontiguousarray(scheme.costing.values,
                                                 np.int32)).to(dev)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost

    def pair(m, n):
        ta = np.zeros((1, m + 1), np.int32)
        tb = np.zeros((1, n + 1), np.int32)
        ta[0, 1:] = rng.integers(0, 4, m)
        tb[0, 1:] = rng.integers(0, 4, n)
        return (torch.from_numpy(ta).to(dev), torch.from_numpy(tb).to(dev),
                cost, gid, go, [m], [n])

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

    calls = {}  # label -> (args, kwargs, tiles the time is divided by)
    for height, width in fill_tile.SHAPES:
        col = pair(64 * height, 32 * width)
        for moves in (True, False):
            calls[f"tile us H={height} W={width}{' codes' if moves else ''}"] = (
                col, dict(want_moves=moves, shape=(height, width)), 64)
    for shape in args.shapes:
        m, n = (int(x) for x in shape.split("x"))
        calls[f"fill ms {shape} codes"] = (pair(m, n), dict(want_moves=True), None)

    out = {"card": card, "reps": args.reps, "times": {}, "gotoh_fill_ms": {}}
    for label, (a, kw, tiles) in calls.items():
        with fill_cuda_only(fill_tile):
            want = fill_cuda.batch_moves(*a, want_moves=kw["want_moves"])
            if tiles is None:
                out["gotoh_fill_ms"][label] = cuda_ms(
                    lambda: fill_cuda.batch_moves(*a, want_moves=kw["want_moves"]))
        turns = {src: [] for src in libs}
        for src in list(libs) + list(libs)[::-1]:
            with bound(src):
                try:
                    got = fill_tile.gotoh_tile(*a, **kw)
                except RuntimeError:  # a build without this (H, W) instance
                    turns[src] = None
                    continue
                if not torch.equal(got[0], want[0]) or (
                        kw["want_moves"] and not torch.equal(got[1], want[1])):
                    raise SystemExit(f"time_tile: {src} != gotoh_fill at {label}")
                t = cuda_ms(lambda: fill_tile.gotoh_tile(*a, **kw))
            turns[src].append(1e3 * t / tiles if tiles else t)
        out["times"][label] = {src: None if v is None else float(np.mean(v))
                               for src, v in turns.items()}
    print(json.dumps(out))
    return 0


@contextlib.contextmanager
def fill_cuda_only(fill_tile):
    """Within: fills go to gotoh_fill (``fill_tile.route`` says no)."""
    real = fill_tile.route
    fill_tile.route = lambda *args: False
    try:
        yield
    finally:
        fill_tile.route = real


if __name__ == "__main__":
    sys.exit(main())

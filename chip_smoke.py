#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_smoke.py`` (no
arguments, one card).  It exits non-zero, printing no result, when no CUDA
device is present or the port's package is not beside it, and when any
phase fails:

  0. print the card's name and power limit (nvidia-smi), build the kernels
     from ``globalign_tpu_torch/csrc`` and print the build time;
  1. kernel vs plain: ``ops.fill_cuda.batch_moves`` on the card against the
     plain row scan on the CPU, same seeded inputs — final3 and every move
     code must be equal (tolerance 0: all integers);
  2. the main path: ``find_global_alignment(..., device="cuda")`` on the
     reference goldens and seeded DNA / protein pairs up to the moves
     budget, each equal (strings, cost, score, report bytes) to the same
     call with ``device="cpu"``; the kernel's launch count must rise by one
     per call;
  3. times with CUDA events: the kernel beside the plain version on the
     card, and end-to-end ``align`` split into fill and D2H + walk, as
     GCUPS over true cells (m*n / s).

The last two lines of standard output are JSON: the kernels' record, then
``{"ok": true, "device": {...}}``.  It uses no JAX and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 20261016
DNA = "ACGT"
PROTEIN = "ACDEFGHIKLMNPQRSTVWY"
# 59 letters that upper-casing keeps, plus the gap: a 60-token alphabet.
WIDE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789!#$%&()*+,./:;<=>?@[]^_"
GOLDEN_E2E = [  # tests/test_conformance.py:19-31
    ("TT", "TA", 3, -4, -5, -2, -1, 7),
    ("TAAAGCTAA", "TAGCTC", 2, -3, -5, -2, -9, 24),
    ("TGGATGAGGCTCCACGCACTAA", "GATTGGTGAGGCTCAGCAT", 2, -3, -5, -2, -15, 56),
    ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA", 2, -3, -5, -2, -21, 62),
    ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA", 4, -5, -3, -5, -20, 102),
    ("GTAGGCGGTC", "CAGCTGC", 1, -2, -5, -2, -18, 28),
    ("CTGTACCG", "CGGAACAGTCCGAT", 1, -2, -5, -2, -18, 26),
    ("GGAGGACGTT", "GAG", 1, -2, -5, -2, -21, 31),
    ("GGAGGACGTT", "GAG", "1", "-2", "-5", "-2", -21, 31),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def random_seq(rng, letters: str, length: int) -> str:
    return "".join(rng.choice(list(letters), length))


def mutate(rng, seq: str, letters: str, identity: float = 0.85) -> str:
    """A relative of ``seq``: substitutions plus short indels, same length."""
    out = []
    p_sub = (1.0 - identity) * 0.6
    p_indel = (1.0 - identity) * 0.2
    for ch in seq:
        r = rng.random()
        if r < p_sub:
            out.append(rng.choice([c for c in letters if c != ch]))
        elif r < p_sub + p_indel:
            continue  # deletion
        elif r < p_sub + 2 * p_indel:
            out.append(ch)
            out.extend(rng.choice(list(letters), int(rng.integers(1, 4))))
        else:
            out.append(ch)
    out = "".join(out)[: len(seq)]
    return out + random_seq(rng, letters, len(seq) - len(out))


def main() -> int:
    if not (REPO / "globalign_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: globalign_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from globalign_tpu_torch import find_global_alignment, resolve_scheme
    from globalign_tpu_torch.models.gotoh import GotohAligner
    from globalign_tpu_torch.ops import fill_cuda, fill_rows
    from globalign_tpu_torch.ops.traceback import traceback_moves
    from globalign_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # -- phase 0: card and build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = f"({smi})"
    t0 = time.perf_counter()
    so_path = cuda_build.build()
    cuda_build.load()
    log(f"phase 0: built {so_path.name} in {time.perf_counter() - t0:.3f} s")

    def tokens(scheme, seqs):
        enc = [scheme.alphabet.encode(s) for s in seqs]
        out = np.zeros((len(seqs), max(len(e) for e in enc) + 1), np.int32)
        for b, e in enumerate(enc):
            out[b, 1 : len(e) + 1] = e
        return torch.from_numpy(out)

    def fill_args(scheme, pairs):
        cost = torch.from_numpy(
            np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
        )
        return (
            tokens(scheme, [p[0] for p in pairs]),
            tokens(scheme, [p[1] for p in pairs]),
            cost,
            scheme.alphabet.gap_id,
            scheme.gap_open_cost,
            [len(p[0]) for p in pairs],
            [len(p[1]) for p in pairs],
        )

    def to_dev(args):
        ta, tb, cost, *rest = args
        return (ta.to(dev), tb.to(dev), cost.to(dev), *rest)

    # -- phase 1: kernel vs plain ---------------------------------------
    schemes = {
        "dna": lambda a, b: resolve_scheme(a, b),
        "blosum62": lambda a, b: resolve_scheme(a, b, scoring_mat_name="BLOSUM62"),
        # odd max score: delta_d != delta_i, so dcost != icost
        "odd_asym": lambda a, b: resolve_scheme(
            a, b, match_score=3, mismatch_score=-2, gap_open_score=-5,
            gap_extension_score=-1,
        ),
        "wide60": lambda a, b: resolve_scheme(a, b, gap_open_cost=3),
    }
    cases = [
        ("dna", DNA, [(1, 1)]),
        ("dna", DNA, [(1, 500)]),
        ("dna", DNA, [(500, 1)]),
        ("dna", DNA, [(37, 129)]),
        ("dna", DNA, [(1000, 1000)]),
        ("blosum62", PROTEIN, [(700, 900)]),
        ("odd_asym", DNA, [(300, 417)]),
        ("wide60", WIDE, [(256, 300)]),
        ("dna", DNA, [(50, 70), (64, 3), (9, 128)]),  # ragged batch of 3
        ("dna", DNA, [(4096, 4096)]),
        ("dna", DNA, [(8000, 8000)]),
    ]
    max_abs_err = 0
    for name, letters, shapes in cases:
        pairs = [
            (random_seq(rng, letters, m), random_seq(rng, letters, n))
            for m, n in shapes
        ]
        if name == "wide60":  # every letter present: alphabet of 60
            pairs[0] = (letters + pairs[0][0][len(letters):], pairs[0][1])
        scheme = schemes[name](*("".join(s) for s in zip(*pairs)))
        if name == "wide60" and scheme.alphabet.size != 60:
            raise SystemExit(f"wide60 alphabet has {scheme.alphabet.size}")
        args = fill_args(scheme, pairs)
        want3, want_mv = fill_cuda.batch_moves(*args)
        got3, got_mv = fill_cuda.batch_moves(*to_dev(args))
        got3 = got3.cpu()
        got_mv = got_mv.cpu()
        torch.cuda.synchronize()
        err = max(
            int((got3.long() - want3.long()).abs().max()),
            int((got_mv.short() - want_mv.short()).abs().max()),
        )
        max_abs_err = max(max_abs_err, err)
        bad = int((got_mv != want_mv).sum())
        log(f"phase 1: {name} {shapes}: final3 {got3.tolist()[:1]} "
            f"code mismatches {bad}, max abs err {err}")
        if err != 0:
            raise SystemExit(f"phase 1 failed: {name} {shapes}")
        # cost-only mode gives the same final3
        got3c, no_mv = fill_cuda.batch_moves(*to_dev(args), want_moves=False)
        if no_mv is not None or not torch.equal(got3c.cpu(), want3):
            raise SystemExit(f"phase 1 failed (cost mode): {name} {shapes}")

    # -- phase 2: the main path -----------------------------------------
    runs = [
        (dict(seq_1="ACGT", seq_2="AGT"), (0, 7)),
    ]
    for s1, s2, ma, mi, go, ge, score, cost in GOLDEN_E2E:
        runs.append((dict(seq_1=s1, seq_2=s2, match_score=ma,
                          mismatch_score=mi, gap_open_score=go,
                          gap_extension_score=ge), (score, cost)))
    s1 = random_seq(rng, DNA, 4096)
    runs.append((dict(seq_1=s1, seq_2=mutate(rng, s1, DNA)), None))
    s1 = random_seq(rng, DNA, 8000)
    runs.append((dict(seq_1=s1, seq_2=mutate(rng, s1, DNA)), None))
    s1 = random_seq(rng, PROTEIN, 1500)
    runs.append((dict(seq_1=s1, seq_2=mutate(rng, s1, PROTEIN),
                      scoring_mat_name="BLOSUM62"), None))

    want = [find_global_alignment(**kw, device="cpu") for kw, _ in runs]
    torch.cuda.synchronize()
    fill_cuda.batch_moves.launches = 0
    got = [find_global_alignment(**kw, device="cuda") for kw, _ in runs]
    launches = fill_cuda.batch_moves.launches
    for (kw, golden), r, w in zip(runs, got, want):
        m, n = len(kw["seq_1"]), len(kw["seq_2"])
        if r != w or str(r) != str(w):
            raise SystemExit(f"phase 2 failed: cuda != cpu for {m} x {n}")
        if golden is not None and (r.score, r.cost) != golden:
            raise SystemExit(f"phase 2 failed: golden {golden} got "
                             f"{(r.score, r.cost)}")
        log(f"phase 2: {m} x {n}: score {r.score} cost {r.cost} "
            f"(= device='cpu')")
    if launches != len(runs):
        raise SystemExit(f"phase 2 failed: {launches} kernel launches for "
                         f"{len(runs)} align calls")
    log(f"phase 2: gotoh_fill launches on the main path: {launches}")

    # -- phase 3: times -------------------------------------------------
    def cuda_ms(fn, reps: int) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    kernel_ms = plain_ms = None
    for size in (4096, 8000):
        s1 = random_seq(rng, DNA, size)
        s2 = mutate(rng, s1, DNA)
        scheme = resolve_scheme(s1, s2)
        args = to_dev(fill_args(scheme, [(s1, s2)]))
        cells = size * size
        k_ms = cuda_ms(lambda: fill_cuda.batch_moves(*args), 5)
        c_ms = cuda_ms(
            lambda: fill_cuda.batch_moves(*args, want_moves=False), 5
        )
        p_ms = cuda_ms(
            lambda: fill_rows.row_fill(
                args[0][0], args[1][0], args[2], args[3], args[4]
            ),
            2,
        )
        log(f"phase 3: fill {size}x{size} on {card}: kernel {k_ms:.4f} ms "
            f"({cells / k_ms / 1e6:.4f} GCUPS), cost-only kernel "
            f"{c_ms:.4f} ms ({cells / c_ms / 1e6:.4f} GCUPS), plain row scan "
            f"on the card {p_ms:.4f} ms ({cells / p_ms / 1e6:.4f} GCUPS)")

        aligner = GotohAligner(scheme, device="cuda")
        aligner.align(s1, s2)  # warm-up
        fill_t, walk_t, total_t = [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aligner.align(s1, s2)
            total_t.append(time.perf_counter() - t0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            final3, moves = fill_cuda.batch_moves(*args)
            end.record()
            end.synchronize()
            fill_t.append(start.elapsed_time(end) / 1e3)
            t1 = time.perf_counter()
            traceback_moves(moves[0].cpu().numpy(), s1, s2,
                            final3[0].cpu().numpy())
            walk_t.append(time.perf_counter() - t1)
        f_ms = 1e3 * float(np.median(fill_t))
        w_ms = 1e3 * float(np.median(walk_t))
        a_ms = 1e3 * float(np.median(total_t))
        log(f"phase 3: align {size}x{size} on {card}: end to end "
            f"{a_ms:.4f} ms ({cells / a_ms / 1e6:.4f} GCUPS); fill "
            f"{f_ms:.4f} ms, D2H + walk {w_ms:.4f} ms")
        kernel_ms, plain_ms = k_ms, p_ms

    log(json.dumps({"kernels": [{
        "name": "gotoh_fill",
        "route": "cuda",
        "source": "globalign_tpu_torch/csrc/gotoh_fill.cu",
        "replaces": "globalign_tpu/ops/fill_lanes.py:201",
        "also_replaces": ["globalign_tpu/ops/fill_pallas.py:496"],
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

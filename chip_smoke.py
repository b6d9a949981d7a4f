#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the root of a checkout with ``python3 chip_smoke.py`` (no
arguments, one card).  It exits non-zero, printing no result, when no CUDA
device is present or the port's package is not beside it, and when any
phase fails:

  0. print the card's name and power limit (nvidia-smi), build the kernels
     from ``globalign_tpu_torch/csrc`` (one nvcc per source, in parallel)
     and print the build time;
  1. kernel vs plain, on the card against the plain versions on the CPU,
     same seeded inputs, tolerance 0 (all integers): ``batch_moves``
     (final3 and every move code); ``batch_moves`` and ``batch_last_rows``
     seeded from a real checkpoint row (``row0`` / ``col0y_top``);
     ``batch_last_rows`` with the default boundary; ``walk_block`` over the
     same codes; the split cost;
  2. the main paths, with every launch count set to 0 before each and read
     after it: ``find_global_alignment(..., device="cuda")`` on the
     reference goldens and pairs up to the moves budget (one fill each,
     equal to ``device="cpu"``); 10 000² and 20 000² DNA and 9000² BLOSUM62
     pairs past the budget (blocked: one checkpoint fill, one replay fill
     and one walk per block), each equal — strings, cost, score, report
     bytes — to the full-matrix route with the budget raised; a 3000 x 2500
     pair forced into >= 4 blocks, equal to ``device="cpu"``; ``cost`` (the
     split from ``SPLIT_MIN_ROWS`` rows, else the direct fill; one launch)
     on every pair, equal to the direct fill and to the alignment's cost;
  3. times with CUDA events: the fill kernel beside the plain row scan on
     the card; end-to-end ``align`` split into fill and D2H + walk; blocked
     ``align`` at 10 000² and 20 000² split into checkpoint pass, replay
     fills, walks, fetch and host assembly, beside the full-matrix route;
     split ``cost`` beside the direct cost-only fill, from a golden-sized
     pair up; the walk kernel beside the plain walk.

The last two lines of standard output are JSON: the kernels' record, then
``{"ok": true, "device": {...}}``.  It uses no JAX and no network.
"""

from __future__ import annotations

import functools
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
    from globalign_tpu_torch import (
        api,
        find_global_alignment,
        resolve_scheme,
        validate_and_transform_args,
    )
    from globalign_tpu_torch.models.gotoh import (
        DEFAULT_MOVES_BUDGET_BYTES,
        SPLIT_MIN_ROWS,
        GotohAligner,
    )
    from globalign_tpu_torch.ops import fill_cuda, fill_rows, fill_split, linear_tb
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
    libs = cuda_build.build()
    cuda_build.load()
    log(f"phase 0: built {', '.join(p.name for p in libs)} in "
        f"{time.perf_counter() - t0:.3f} s")

    counters = {
        "batch_moves": fill_cuda.batch_moves,
        "batch_last_rows": fill_cuda.batch_last_rows,
        "walk_block": linear_tb.walk_block,
    }

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    main_launches = dict.fromkeys(counters, 0)

    def add_main(counts):
        for name, k in counts.items():
            main_launches[name] += k

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

    def abs_err(got, want):
        """Max |got - want| over integer tensors (got on the card)."""
        return int((got.cpu().long() - want.long()).abs().max())

    def make_pairs(name, letters, shapes):
        pairs = [
            (random_seq(rng, letters, m), random_seq(rng, letters, n))
            for m, n in shapes
        ]
        if name == "wide60":  # every letter present: alphabet of 60
            pairs[0] = (letters + pairs[0][0][len(letters):], pairs[0][1])
        scheme = schemes[name](*("".join(s) for s in zip(*pairs)))
        if name == "wide60" and scheme.alphabet.size != 60:
            raise SystemExit(f"wide60 alphabet has {scheme.alphabet.size}")
        return fill_args(scheme, pairs)

    max_abs_err = 0
    for name, letters, shapes in cases:
        args = make_pairs(name, letters, shapes)
        want3, want_mv = fill_cuda.batch_moves(*args)
        got3, got_mv = fill_cuda.batch_moves(*to_dev(args))
        got3 = got3.cpu()
        got_mv = got_mv.cpu()
        torch.cuda.synchronize()
        err = max(abs_err(got3, want3), abs_err(got_mv, want_mv))
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

    # Injection: cut each pair at row i0; the plain fill's last row i0 and
    # Iy(i0, 0) seed the rows below, on the card and on the CPU.
    inj_cases = [
        ("dna", DNA, [(4096, 4096)], [2048]),
        # the main path's widths: a short block below row 1000 of a
        # 10 000-column pair (w = 10), of a 20 000-column pair (w = 20,
        # strip state in global memory), of a 9000-column BLOSUM62 pair,
        # and a ragged batch with per-pair state in global memory
        ("dna", DNA, [(1300, 10_000)], [1000]),
        ("dna", DNA, [(1300, 20_000)], [1000]),
        ("blosum62", PROTEIN, [(1300, 9_000)], [1000]),
        ("dna", DNA, [(300, 20_000), (1256, 19_000), (70, 12_500)],
         [44, 1000, 6]),
        ("dna", DNA, [(1000, 1000)], [999]),  # a one-row block
        ("dna", DNA, [(1, 500)], [0]),
        ("blosum62", PROTEIN, [(700, 900)], [301]),
        ("odd_asym", DNA, [(300, 417)], [150]),
        ("wide60", WIDE, [(256, 300)], [100]),
        ("dna", DNA, [(50, 70), (64, 3), (9, 128)], [20, 63, 0]),
    ]
    walk_codes = {}  # columns -> (codes, final3) of an injected block
    for name, letters, shapes, cuts in inj_cases:
        ta, tb, cost, gid, go, mt, nt = make_pairs(name, letters, shapes)
        top = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, cuts, nt)
        blk = torch.zeros_like(ta)
        c0 = torch.empty(len(mt), dtype=torch.int32)
        for b, i0 in enumerate(cuts):
            blk[b, 1 : mt[b] - i0 + 1] = ta[b, i0 + 1 : mt[b] + 1]
            c0[b] = go if i0 == 0 else int(top[b, 2, 0])
        rows = [m - i0 for m, i0 in zip(mt, cuts)]
        args = (blk, tb, cost, gid, go, rows, nt)
        inj = dict(row0=top, col0y_top=c0)
        dev_inj = dict(row0=top.to(dev), col0y_top=c0.to(dev))
        want3, want_mv = fill_cuda.batch_moves(*args, **inj)
        want_last = fill_cuda.batch_last_rows(*args, **inj)
        want_def = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, mt, nt)
        got3, got_mv = fill_cuda.batch_moves(*to_dev(args), **dev_inj)
        got_last = fill_cuda.batch_last_rows(*to_dev(args), **dev_inj)
        got_def = fill_cuda.batch_last_rows(
            *to_dev((ta, tb, cost, gid, go, mt, nt))
        )
        torch.cuda.synchronize()
        err = max(abs_err(got3, want3), abs_err(got_mv, want_mv),
                  abs_err(got_last, want_last), abs_err(got_def, want_def))
        max_abs_err = max(max_abs_err, err)
        log(f"phase 1: injected {name} {shapes} cut at {cuts}: codes, final3, "
            f"last rows (injected and default) max abs err {err}")
        if err != 0:
            raise SystemExit(f"phase 1 failed (injection): {name} {shapes}")
        if len(shapes) == 1 and shapes[0][1] in (4096, 20_000):
            walk_codes[shapes[0][1]] = (got_mv, got3)

    # The walk over the injected 4096- and 20 000-column blocks' codes,
    # from the block's corner and from inside it.
    walk_err = 0
    for walk_moves, walk_final3 in walk_codes.values():
        k_rows = walk_moves.shape[1] - 1
        n_cols = walk_moves.shape[2] - 1
        for i_entry, j_entry in (([k_rows], [n_cols]), ([k_rows // 3], [17])):
            level = walk_final3.argmin(-1).to(torch.int32)
            j_dev = torch.tensor(j_entry, dtype=torch.int32, device=dev)
            want = linear_tb.walk_block(walk_moves.cpu(), i_entry,
                                        j_dev.cpu(), level.cpu())
            got = linear_tb.walk_block(walk_moves, i_entry, j_dev, level)
            torch.cuda.synchronize()
            err = max(abs_err(g, w) for g, w in zip(got, want))
            walk_err = max(walk_err, err)
            log(f"phase 1: walk_block {k_rows} x {n_cols} from "
                f"({i_entry[0]}, {j_entry[0]}): {int(got[1][0])} steps, max "
                f"abs err {err}")
    if walk_err != 0:
        raise SystemExit("phase 1 failed: walk_block != plain walk")

    # The split cost on the card against its plain version.
    for name, letters, (m, n) in (("dna", DNA, (2, 0)), ("dna", DNA, (1, 300)),
                                  ("dna", DNA, (2000, 1999)),
                                  ("blosum62", PROTEIN, (701, 900)),
                                  ("dna", DNA, (300, 10_000)),
                                  ("dna", DNA, (3, 20_000)),
                                  ("blosum62", PROTEIN, (301, 9_000))):
        ta, tb, cost, gid, go, _, _ = make_pairs(name, letters, [(m, n)])
        want = fill_split.split_fill_cost(ta[0], tb[0], cost, gid, go)
        got = fill_split.split_fill_cost(
            ta[0].to(dev), tb[0].to(dev), cost.to(dev), gid, go
        )
        err = abs_err(got, want)
        max_abs_err = max(max_abs_err, err)
        log(f"phase 1: split cost {name} {m} x {n}: {int(got)}, max abs err "
            f"{err}")
        if err != 0:
            raise SystemExit(f"phase 1 failed (split): {name} {m} x {n}")

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
    reset_counts()
    got = [find_global_alignment(**kw, device="cuda") for kw, _ in runs]
    counts = read_counts()
    add_main(counts)
    for (kw, golden), r, w in zip(runs, got, want):
        m, n = len(kw["seq_1"]), len(kw["seq_2"])
        if r != w or str(r) != str(w):
            raise SystemExit(f"phase 2 failed: cuda != cpu for {m} x {n}")
        if golden is not None and (r.score, r.cost) != golden:
            raise SystemExit(f"phase 2 failed: golden {golden} got "
                             f"{(r.score, r.cost)}")
        log(f"phase 2: {m} x {n}: score {r.score} cost {r.cost} "
            f"(= device='cpu')")
    if counts != dict(batch_moves=len(runs), batch_last_rows=0, walk_block=0):
        raise SystemExit(f"phase 2 failed: launches {counts} for "
                         f"{len(runs)} align calls")
    log(f"phase 2: launches on the full-matrix path: {counts}")

    # Past the moves budget: the blocked route, held against the
    # full-matrix route (the same call with the budget raised).
    def full_matrix_route(**kw):
        real = api.GotohAligner
        api.GotohAligner = functools.partial(real, moves_budget_bytes=1 << 40)
        try:
            return find_global_alignment(**kw, device="cuda")
        finally:
            api.GotohAligner = real

    long_runs, long_results = [], []
    for size, letters, kw in ((10_000, DNA, {}), (20_000, DNA, {}),
                              (9_000, PROTEIN,
                               dict(scoring_mat_name="BLOSUM62"))):
        s1 = random_seq(rng, letters, size)
        long_runs.append(dict(seq_1=s1, seq_2=mutate(rng, s1, letters), **kw))
    for kw in long_runs:
        m, n = len(kw["seq_1"]), len(kw["seq_2"])
        nblocks = len(linear_tb.block_bounds(
            m, n, block_moves_bytes=DEFAULT_MOVES_BUDGET_BYTES
        )) - 1
        torch.cuda.synchronize()
        reset_counts()
        r = find_global_alignment(**kw, device="cuda")
        counts = read_counts()
        add_main(counts)
        long_results.append(r)
        design = dict(batch_moves=nblocks, batch_last_rows=nblocks,
                      walk_block=nblocks)
        w = full_matrix_route(**kw)
        if r != w or str(r) != str(w):
            raise SystemExit(f"phase 2 failed: blocked != full matrix for "
                             f"{m} x {n}")
        if counts != design:
            raise SystemExit(f"phase 2 failed: {m} x {n} launches {counts}, "
                             f"design {design}")
        log(f"phase 2: blocked {m} x {n} ({nblocks} blocks): score {r.score} "
            f"cost {r.cost} (= full-matrix route, report bytes equal); "
            f"launches {counts}")

    # A small pair forced into >= 4 blocks, against the CPU engine.
    s1 = random_seq(rng, DNA, 3000)
    forced = dict(seq_1=s1, seq_2=mutate(rng, s1, DNA)[:2500])
    scheme = resolve_scheme(forced["seq_1"], forced["seq_2"])
    budget = 2_000_000
    nblocks = len(linear_tb.block_bounds(
        len(forced["seq_1"]), len(forced["seq_2"]), block_moves_bytes=budget
    )) - 1
    want_forced = find_global_alignment(**forced, device="cpu")
    torch.cuda.synchronize()
    reset_counts()
    r = GotohAligner(scheme, moves_budget_bytes=budget, device="cuda").align(
        forced["seq_1"], forced["seq_2"]
    )
    counts = read_counts()
    add_main(counts)
    if nblocks < 4 or counts != dict(batch_moves=nblocks,
                                     batch_last_rows=nblocks,
                                     walk_block=nblocks):
        raise SystemExit(f"phase 2 failed: forced blocks {nblocks}, "
                         f"launches {counts}")
    if (r.seq_1_aligned, r.middle_part, r.seq_2_aligned, r.cost, r.score) != (
        want_forced.seq_1_aligned, want_forced.middle_part,
        want_forced.seq_2_aligned, want_forced.cost, want_forced.score,
    ):
        raise SystemExit("phase 2 failed: forced blocks != device='cpu'")
    log(f"phase 2: 3000 x 2500 in {nblocks} blocks: cost {r.cost} "
        f"(= device='cpu'); launches {counts}")

    # cost(): the split, one launch, on every pair above.
    cost_runs = (
        [(kw, w) for (kw, _), w in zip(runs, want)]
        + list(zip(long_runs, long_results))
        + [(forced, want_forced)]
    )
    for kw, r in cost_runs:
        s1, s2 = kw["seq_1"], kw["seq_2"]
        aligner = GotohAligner(
            validate_and_transform_args(**kw).scheme, device="cuda"
        )
        torch.cuda.synchronize()
        reset_counts()
        c = aligner.cost(s1, s2)
        counts = read_counts()
        add_main(counts)
        split = len(s1) >= SPLIT_MIN_ROWS
        design = dict(batch_moves=int(not split),
                      batch_last_rows=int(split), walk_block=0)
        direct, _ = aligner._batch_fill(s1, s2, want_moves=False)
        if counts != design or c != int(direct.min()) or c != r.cost:
            raise SystemExit(f"phase 2 failed: cost {c} direct "
                             f"{int(direct.min())} align {r.cost} launches "
                             f"{counts} for {len(s1)} x {len(s2)}")
    log(f"phase 2: cost on {len(cost_runs)} pairs (the split from "
        f"{SPLIT_MIN_ROWS} rows) = direct fill = alignment cost; one launch "
        "each")
    log(f"phase 2: launches on the main paths: {main_launches}")

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

    # The last-row mode, injected (a checkpoint fill), beside the plain
    # row scan on the card.
    s1 = random_seq(rng, DNA, 4096)
    s2 = mutate(rng, s1, DNA)
    args = to_dev(fill_args(resolve_scheme(s1, s2), [(s1, s2)]))
    row0 = fill_cuda.batch_last_rows(*args)
    c0 = torch.full((1,), args[4], dtype=torch.int32, device=dev)
    last_ms = cuda_ms(
        lambda: fill_cuda.batch_last_rows(*args, row0=row0, col0y_top=c0), 5
    )
    plain_last_ms = cuda_ms(
        lambda: fill_rows.row_fill(
            args[0][0], args[1][0], args[2], args[3], args[4], row0=row0[0],
            want_moves=False,
        ),
        2,
    )
    log(f"phase 3: injected last-row fill 4096x4096 on {card}: kernel "
        f"{last_ms:.4f} ms ({4096 * 4096 / last_ms / 1e6:.4f} GCUPS), plain "
        f"row scan on the card {plain_last_ms:.4f} ms")

    # Blocked align, phase by phase, beside the full-matrix route; the
    # split cost beside the direct cost-only fill; the walk kernel beside
    # the plain walk.
    def median_s(fn, reps: int = 3) -> float:
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return float(np.median(out))

    walk_ms = plain_walk_ms = None
    for size in (10_000, 20_000):
        s1 = random_seq(rng, DNA, size)
        s2 = mutate(rng, s1, DNA)
        cells = size * size
        scheme = resolve_scheme(s1, s2)
        blocked = GotohAligner(scheme, device="cuda")
        full = GotohAligner(scheme, moves_budget_bytes=1 << 40, device="cuda")
        enc = (blocked._encode(s1), blocked._encode(s2), blocked.cost_mat,
               blocked.gap_id, blocked.gap_open, s1, s2)
        budget = blocked.moves_budget_bytes
        blocked.align(s1, s2)  # warm-up
        parts = []
        for _ in range(3):
            marks = []

            def on_phase(label):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((label, ev, time.perf_counter()))

            torch.cuda.synchronize()
            on_phase("start")
            linear_tb.align_blocked(
                *enc, block_moves_bytes=budget, on_phase=on_phase
            )
            dev_ms = {"checkpoints": 0.0, "fill": 0.0, "walk": 0.0,
                      "fetch": 0.0}
            for (_, e0, _), (label, e1, _) in zip(marks, marks[1:]):
                if label in dev_ms:
                    dev_ms[label] += e0.elapsed_time(e1)
            host = {label: t for label, _, t in marks}
            last_walk = [t for label, _, t in marks if label == "walk"][-1]
            parts.append((
                dev_ms["checkpoints"], dev_ms["fill"], dev_ms["walk"],
                dev_ms["fetch"],
                1e3 * (last_walk - host["start"]),
                1e3 * (host["fetch"] - last_walk),
                1e3 * (host["assembled"] - host["fetch"]),
                1e3 * (host["assembled"] - host["start"]),
            ))
        ck, fi, wa, fe, enq, wait, asm, tot = (
            float(np.median(c)) for c in zip(*parts)
        )
        nblocks = len(linear_tb.block_bounds(
            size, len(s2), block_moves_bytes=budget
        )) - 1
        b_ms = 1e3 * median_s(lambda: blocked.align(s1, s2))
        full.align(s1, s2)  # warm-up
        f_ms = 1e3 * median_s(lambda: full.align(s1, s2))
        full_args = to_dev(fill_args(scheme, [(s1, s2)]))
        ff_ms = cuda_ms(lambda: fill_cuda.batch_moves(*full_args), 3)
        log(f"phase 3: blocked align {size}x{len(s2)} ({nblocks} blocks) on "
            f"{card}: end to end {b_ms:.4f} ms ({cells / b_ms / 1e6:.4f} "
            f"GCUPS); align_blocked {tot:.4f} ms; device: checkpoint pass "
            f"{ck:.4f} ms + replay fills {fi:.4f} ms + walks {wa:.4f} ms + "
            f"tape fetch {fe:.4f} ms; host: enqueue {enq:.4f} ms, wait for "
            f"the device and fetch {wait:.4f} ms, assembly {asm:.4f} ms")
        log(f"phase 3: full-matrix align {size}x{len(s2)} on {card}: end to "
            f"end {f_ms:.4f} ms ({cells / f_ms / 1e6:.4f} GCUPS); fill "
            f"{ff_ms:.4f} ms")

        direct_args = to_dev(fill_args(scheme, [(s1, s2)]))
        split_ms = cuda_ms(lambda: fill_split.split_fill_cost(*enc[:5]), 3)
        direct_ms = cuda_ms(
            lambda: fill_cuda.batch_moves(*direct_args, want_moves=False), 3
        )
        cost_ms = 1e3 * median_s(lambda: blocked.cost(s1, s2))
        log(f"phase 3: cost {size}x{len(s2)} on {card}: split {split_ms:.4f} "
            f"ms (one 2-pair launch + join), direct cost-only fill "
            f"{direct_ms:.4f} ms; cost() end to end {cost_ms:.4f} ms")

        if size == 10_000:  # the walk over a whole 10 000-row matrix
            final3, moves = fill_cuda.batch_moves(*full_args)
            level = final3.argmin(-1).to(torch.int32)
            j_dev = torch.full((1,), len(s2), dtype=torch.int32, device=dev)
            walk_ms = cuda_ms(
                lambda: linear_tb.walk_block(moves, [size], j_dev, level), 3
            )
            moves_cpu, j_cpu, level_cpu = moves.cpu(), j_dev.cpu(), level.cpu()
            t0 = time.perf_counter()
            want = linear_tb.walk_block(moves_cpu, [size], j_cpu, level_cpu)
            plain_walk_ms = 1e3 * (time.perf_counter() - t0)
            got = linear_tb.walk_block(moves, [size], j_dev, level)
            err = max(abs_err(g, w) for g, w in zip(got, want))
            walk_err = max(walk_err, err)
            log(f"phase 3: walk {size}x{len(s2)} ({int(want[1][0])} steps) on "
                f"{card}: kernel {walk_ms:.4f} ms, plain walk on the host "
                f"{plain_walk_ms:.4f} ms; ops, count, j_exit, level_exit max "
                f"abs err {err}")
            if err != 0:
                raise SystemExit("phase 3 failed: walk_block != plain walk")

    # cost(): the split beside the direct cost-only fill, end to end on the
    # host clock (tokens to the int the caller gets), from a golden-sized
    # pair up, on both sides of SPLIT_MIN_ROWS.
    for size in (24, 512, 1023, 1024, 2048, 4096):
        s1 = random_seq(rng, DNA, size)
        s2 = mutate(rng, s1, DNA)
        aligner = GotohAligner(resolve_scheme(s1, s2), device="cuda")

        def split_cost():
            return int(fill_split.split_fill_cost(
                aligner._encode(s1), aligner._encode(s2), aligner.cost_mat,
                aligner.gap_id, aligner.gap_open,
            ))

        def direct_cost():
            final3, _ = aligner._batch_fill(s1, s2, want_moves=False)
            return int(final3.min())

        if split_cost() != direct_cost():
            raise SystemExit(f"phase 3 failed: split != direct at {size}")
        reps = 21 if size < 4096 else 5
        sp_ms = 1e3 * median_s(split_cost, reps)
        di_ms = 1e3 * median_s(direct_cost, reps)
        co_ms = 1e3 * median_s(lambda: aligner.cost(s1, s2), reps)
        log(f"phase 3: cost {size}x{len(s2)} on {card}: split {sp_ms:.4f} "
            f"ms, direct {di_ms:.4f} ms, cost() {co_ms:.4f} ms (split from "
            f"{SPLIT_MIN_ROWS} rows)")

    log(json.dumps({"kernels": [
        {
            "name": "gotoh_fill",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/gotoh_fill.cu",
            "replaces": "globalign_tpu/ops/fill_lanes.py:201",
            "also_replaces": [
                "globalign_tpu/ops/fill_pallas.py:496",
                "globalign_tpu/ops/fill_pallas.py:153",
                "globalign_tpu/ops/fill_pallas.py:735",
            ],
            "launches": main_launches["batch_moves"]
            + main_launches["batch_last_rows"],
            "launches_by_wrapper": {
                k: main_launches[k] for k in ("batch_moves", "batch_last_rows")
            },
            "max_abs_err": max_abs_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "last_rows_ms": last_ms,
            "plain_last_rows_ms": plain_last_ms,
        },
        {
            "name": "walk_block",
            "route": "cuda",
            "source": "globalign_tpu_torch/csrc/walk_block.cu",
            "replaces": "globalign_tpu/ops/linear_tb.py:74",
            "launches": main_launches["walk_block"],
            "max_abs_err": walk_err,
            "ms": walk_ms,
            "plain_ms": plain_walk_ms,
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The CUDA kernel against its plain version — needs an NVIDIA GPU.

Every test here is marked ``cuda`` and skips (inside the ``cuda_device``
fixture) where no CUDA device is present.  This file imports neither JAX
nor the JAX package, so on a machine with the card and without JAX it runs
alone:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q -m "not slow"

and the full-size checks marked ``slow`` (minutes each: the mpox cell's
call against the reference) alone with ``-m slow``.

Tolerance 0: final3, last rows, move codes, op tapes and costs are
integers, and alignments are strings.
"""

import collections
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from globalign_tpu_torch import (
    GotohAligner,
    align_pairs,
    final_cost_to_score,
    find_global_alignment,
    resolve_scheme,
    validate_and_transform_args,
)
from globalign_tpu_torch import batch as batch_mod
from globalign_tpu_torch.batch import bucket_length
from globalign_tpu_torch.models.gotoh import DEFAULT_MOVES_BUDGET_BYTES, SPLIT_MIN_ROWS
from globalign_tpu_torch.ops import (
    fill_batch,
    fill_cuda,
    fill_split,
    fill_tile,
    fill_wave,
    linear_tb,
    packed,
)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]

TABLE_LETTERS = "".join(chr(0x4E00 + k) for k in range(399))  # a 640 KB table
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
BLOSUM = dict(scoring_mat_name="BLOSUM62")
ODD = dict(match_score=3, mismatch_score=-2, gap_open_score=-5,
           gap_extension_score=-1)  # an odd max score: dcost != icost
# 59 letters that upper-casing keeps, plus the gap: a 60-token alphabet
WIDE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789!#$%&()*+,./:;<=>?@[]^_"
WIDE_KW = dict(gap_open_cost=3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _case(rng, letters, shapes, **scheme_kw):
    pairs = [
        ("".join(rng.choice(list(letters), m)),
         "".join(rng.choice(list(letters), n)))
        for m, n in shapes
    ]
    scheme = resolve_scheme(
        "".join(letters), "".join(letters), **scheme_kw
    )
    return _args(scheme, pairs)


def _args(scheme, pairs):
    """The fill arguments of ``pairs`` under ``scheme``: tokens (1-origin,
    padded), the cost table, the gap token and cost, and the lengths."""
    ta = np.zeros((len(pairs), max(len(a) for a, _ in pairs) + 1), np.int32)
    tb = np.zeros((len(pairs), max(len(b) for _, b in pairs) + 1), np.int32)
    for k, (s1, s2) in enumerate(pairs):
        ta[k, 1 : len(s1) + 1] = scheme.alphabet.encode(s1)
        tb[k, 1 : len(s2) + 1] = scheme.alphabet.encode(s2)
    cost = np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
    return (torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cost),
            scheme.alphabet.gap_id, scheme.gap_open_cost,
            [len(a) for a, _ in pairs], [len(b) for _, b in pairs])


def _on(dev, args):
    ta, tb, cost, *rest = args
    return (ta.to(dev), tb.to(dev), cost.to(dev), *rest)


def _assert_kernel_equals_plain(dev, args):
    want3, want_mv = fill_cuda.batch_moves(*args)
    before = fill_cuda.batch_moves.launches
    got3, got_mv = fill_cuda.batch_moves(*_on(dev, args))
    torch.cuda.synchronize()
    assert fill_cuda.batch_moves.launches == before + 1
    assert torch.equal(got3.cpu(), want3)
    assert torch.equal(got_mv.cpu(), want_mv)
    cost3, none = fill_cuda.batch_moves(*_on(dev, args), want_moves=False)
    assert none is None and torch.equal(cost3.cpu(), want3)


@pytest.mark.parametrize(
    "shapes",
    [[(1, 1)], [(0, 5)], [(7, 0)], [(0, 0)], [(33, 65)],
     [(40, 3), (5, 90), (64, 64), (1, 1)]],
)
def test_kernel_matches_plain_small(cuda_device, shapes):
    rng = np.random.default_rng(len(shapes) + shapes[0][0])
    _assert_kernel_equals_plain(cuda_device, _case(rng, "ACGT", shapes))


def test_kernel_matches_plain_blosum_and_odd_scheme(cuda_device):
    rng = np.random.default_rng(5)
    _assert_kernel_equals_plain(
        cuda_device,
        _case(rng, "ARNDCQEGHILKMFPSTWYV", [(120, 200)],
              scoring_mat_name="BLOSUM62"),
    )
    _assert_kernel_equals_plain(
        cuda_device,
        _case(rng, "ACGT", [(150, 97)], match_score=3, mismatch_score=-2,
              gap_open_score=-5, gap_extension_score=-1),
    )


def test_kernel_matches_plain_with_the_table_in_global_memory(cuda_device):
    """A 400-letter alphabet: its 640 KB cost table exceeds shared memory,
    so the kernel reads it from global memory."""
    rng = np.random.default_rng(6)
    letters = "".join(chr(0x4E00 + k) for k in range(399))
    _assert_kernel_equals_plain(cuda_device, _case(rng, letters, [(60, 80)]))


def test_kernel_matches_plain_with_the_strip_state_in_global_memory(cuda_device):
    """20 000 columns: the strip state (16 bytes a column) is more than
    a block's shared memory holds; it lives in registers, W = 16 columns a
    lane over a cluster of 8 blocks."""
    rng = np.random.default_rng(7)
    _assert_kernel_equals_plain(cuda_device, _case(rng, "ACGT", [(9, 20000)]))


def test_main_path_runs_the_kernel(cuda_device):
    """One fill launch (gotoh_tile where fill_tile.route sends the pair,
    gotoh_fill else) and one walk launch."""
    rng = np.random.default_rng(8)
    s1 = "".join(rng.choice(list("ACGT"), 300))
    s2 = "".join(rng.choice(list("ACGT"), 280))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tiled = fill_tile.route(1, 300, 280, True, sms)
    before = (fill_cuda.batch_moves.launches, fill_tile.gotoh_tile.launches,
              linear_tb.walk_block.launches)
    got = find_global_alignment(seq_1=s1, seq_2=s2, device="cuda")
    assert (fill_cuda.batch_moves.launches, fill_tile.gotoh_tile.launches,
            linear_tb.walk_block.launches) == (
        before[0] + (not tiled), before[1] + tiled, before[2] + 1)
    want = find_global_alignment(seq_1=s1, seq_2=s2, device="cpu")
    assert got == want and str(got) == str(want)


# The launch shapes of fill_cuda.plan: 1, 2 and 8 bands, band widths +-1,
# passes (32 768 columns a cluster with codes, 65 536 without) +-1, fewer
# than 32 columns, one column, m_true 0 and 1, and ragged batches whose
# pairs get different band counts.
PLAN_SHAPES = [
    [(40, 100)], [(40, 256)], [(90, 8000)], [(300, 8000)],
    [(30, 127)], [(30, 128)], [(30, 129)],
    [(30, 1023)], [(30, 1024)], [(30, 1025)],
    [(20, 2047)], [(20, 2048)], [(20, 2049)],
    [(20, 8191)], [(20, 8192)], [(20, 8193)],
    [(5, 32_767)], [(5, 32_768)], [(5, 32_769)],
    [(3, 65_535)], [(3, 65_536)], [(3, 65_537)],
    [(1, 1)], [(0, 1)], [(1, 0)], [(0, 0)], [(7, 5)],
    [(0, 31)], [(1, 31)], [(33, 31)],
    [(300, 8000), (0, 300), (1, 33), (64, 1)],
    [(100, 4096), (100, 1), (7, 2049), (0, 0), (50, 700)],
    [(90, 8000), (0, 300), (1, 33), (64, 1)],
    [(50, 4096), (50, 1), (7, 2049), (0, 0), (30, 700)],
]


@pytest.mark.parametrize("shapes", PLAN_SHAPES)
def test_plan_shapes_match_plain(cuda_device, shapes):
    """Codes, final3 and last rows, plain and injected below row m // 2, at
    the plan's band and pass edges; one launch a call."""
    rng = np.random.default_rng(sum(n for _, n in shapes) + len(shapes))
    args = _case(rng, "ACGT", shapes)
    _assert_kernel_equals_plain(cuda_device, args)
    want = fill_cuda.batch_last_rows(*args)
    got = fill_cuda.batch_last_rows(*_on(cuda_device, args))
    assert torch.equal(got.cpu(), want)
    blk, top, c0 = _checkpointed(args, [m // 2 for m in args[5]])
    inj = dict(row0=top, col0y_top=c0)
    dev_inj = {k: v.to(cuda_device) for k, v in inj.items()}
    want3, want_mv = fill_cuda.batch_moves(*blk, **inj)
    got3, got_mv = fill_cuda.batch_moves(*_on(cuda_device, blk), **dev_inj)
    assert torch.equal(got3.cpu(), want3) and torch.equal(got_mv.cpu(), want_mv)
    want = fill_cuda.batch_last_rows(*blk, **inj)
    got = fill_cuda.batch_last_rows(*_on(cuda_device, blk), **dev_inj)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_kernel_rejects_mixed_devices(cuda_device):
    args = _case(np.random.default_rng(9), "ACGT", [(4, 4)])
    ta, tb, cost, *rest = _on(cuda_device, args)
    with pytest.raises(ValueError, match="is on"):
        fill_cuda.batch_moves(ta, tb, cost.cpu(), *rest)


def _checkpointed(args, split_rows):
    """Cut each pair of ``args`` at row i0 = split_rows[b]: the rows below as
    a block, seeded with the plain fill's last row i0 and Iy(i0, 0)."""
    ta, tb, cost, gid, go, mt, nt = args
    top = fill_cuda.batch_last_rows(ta, tb, cost, gid, go, split_rows, nt)
    blk = torch.zeros_like(ta)
    c0 = torch.empty(len(mt), dtype=torch.int32)
    for b, i0 in enumerate(split_rows):
        blk[b, 1 : mt[b] - i0 + 1] = ta[b, i0 + 1 : mt[b] + 1]
        c0[b] = go if i0 == 0 else int(top[b, 2, 0])  # Iy(i0, 0)
    rest = [m - i0 for m, i0 in zip(mt, split_rows)]
    return (blk, tb, cost, gid, go, rest, nt), top, c0


@pytest.mark.parametrize(
    "letters,shapes,splits,scheme_kw",
    [
        ("ACGT", [(300, 257)], [150], {}),
        ("ACGT", [(1, 40)], [0], {}),
        ("ACGT", [(90, 70), (40, 3), (61, 128)], [30, 39, 0], {}),
        ("ARNDCQEGHILKMFPSTWYV", [(200, 230)], [77], dict(scoring_mat_name="BLOSUM62")),
        ("ACGT", [(150, 97)], [100], dict(match_score=3, mismatch_score=-2,
                                           gap_open_score=-5, gap_extension_score=-1)),
        # 20 000 columns: W = 16 over 8 bands of 5 warps (a replay block)
        ("ACGT", [(100, 20000)], [60], {}),
    ],
)
def test_injected_fills_match_plain(cuda_device, letters, shapes, splits, scheme_kw):
    """``batch_moves`` and ``batch_last_rows`` seeded from a real
    checkpoint row: kernel == plain, codes, final3 and last rows."""
    rng = np.random.default_rng(len(shapes) + shapes[0][0])
    blk, top, c0 = _checkpointed(_case(rng, letters, shapes, **scheme_kw), splits)
    inj = dict(row0=top, col0y_top=c0)
    want3, want_mv = fill_cuda.batch_moves(*blk, **inj)
    want_last = fill_cuda.batch_last_rows(*blk, **inj)
    dev_inj = dict(row0=top.to(cuda_device), col0y_top=c0.to(cuda_device))
    before = (fill_cuda.batch_moves.launches, fill_cuda.batch_last_rows.launches)
    got3, got_mv = fill_cuda.batch_moves(*_on(cuda_device, blk), **dev_inj)
    got_last = fill_cuda.batch_last_rows(*_on(cuda_device, blk), **dev_inj)
    torch.cuda.synchronize()
    assert (fill_cuda.batch_moves.launches, fill_cuda.batch_last_rows.launches) == (
        before[0] + 1, before[1] + 1
    )
    assert torch.equal(got3.cpu(), want3)
    assert torch.equal(got_mv.cpu(), want_mv)
    assert torch.equal(got_last.cpu(), want_last)


@pytest.mark.parametrize("alone", ["row0", "col0y_top"])
def test_one_injected_input_alone_matches_plain(cuda_device, alone):
    """``row0`` without ``col0y_top`` and the reverse: the kernel reads the
    one given and keeps the default for the other, as the plain version."""
    rng = np.random.default_rng(14)
    blk, top, c0 = _checkpointed(_case(rng, "ACGT", [(120, 150)]), [50])
    inj = dict(row0=top) if alone == "row0" else dict(col0y_top=c0)
    want3, want_mv = fill_cuda.batch_moves(*blk, **inj)
    want_last = fill_cuda.batch_last_rows(*blk, **inj)
    dev_inj = {k: v.to(cuda_device) for k, v in inj.items()}
    got3, got_mv = fill_cuda.batch_moves(*_on(cuda_device, blk), **dev_inj)
    got_last = fill_cuda.batch_last_rows(*_on(cuda_device, blk), **dev_inj)
    assert torch.equal(got3.cpu(), want3)
    assert torch.equal(got_mv.cpu(), want_mv)
    assert torch.equal(got_last.cpu(), want_last)


@pytest.mark.parametrize("shapes", [[(0, 7)], [(7, 0)], [(0, 0)], [(1, 1)], [(5, 9), (0, 9), (3, 0)]])
def test_last_rows_boundary_shapes_match_plain(cuda_device, shapes):
    """Zero-row and zero-column pairs write their whole boundary row."""
    args = _case(np.random.default_rng(3), "ACGT", shapes)
    want = fill_cuda.batch_last_rows(*args)
    got = fill_cuda.batch_last_rows(*_on(cuda_device, args))
    assert torch.equal(got.cpu(), want)


def _synthetic_codes(rng, levels, k, n):
    """(1, k+1, n+1) codes whose every cell sends level l to ``levels[l]``
    (a level of -1: random; -2: random, but level l itself 70% of the
    time, 80% for M)."""
    lv = rng.integers(0, 3, (k + 1, n + 1, 3))
    for lvl, to in enumerate(levels):
        if to >= 0:
            lv[..., lvl] = to
        elif to == -2:
            stay = rng.random((k + 1, n + 1)) < (0.8 if lvl == 0 else 0.7)
            lv[..., lvl] = np.where(stay, lvl, lv[..., lvl])
    return torch.from_numpy(
        (lv[..., 0] | lv[..., 1] << 2 | lv[..., 2] << 4).astype(np.uint8)[None])


# The walk kernel's tile edges (32 x 48 codes a tile in shared memory; the
# diagonal walk passes the corners (96, 256) of 32 x 128 and (32, 192) of
# 32 x 48 tiles):
# (name, rows and columns of a DNA fill or synthetic codes, entries).
WALK_CASES = {
    "ragged_entries": ([(120, 90), (64, 100), (7, 5)], None,
                       ([120, 50, 0], [90, 100, 5])),
    "up_through_tile_tops": ([(300, 700)], (2, 2, 2), ([300], [700])),
    "left_to_column_0_inside_a_tile": ([(300, 700)], (1, 1, 1), ([150], [700])),
    "diagonal_through_tile_corners": ([(300, 700)], (0, 0, 0), ([101], [261])),
    "random_codes": ([(300, 700)], (-1, -1, -1), ([300], [700])),
    "biased_random_codes": ([(300, 1000)], (-2, -2, -2), ([300], [1000])),
    "3x40000": ([(3, 40_000)], None, ([3], [40_000])),
    "40000x3": ([(40_000, 3)], None, ([40_000], [3])),
    "m_or_n_0_and_1": ([(0, 5), (5, 0), (1, 1), (1, 9), (9, 1)], None,
                       ([0, 5, 1, 1, 9], [5, 0, 1, 9, 1])),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES) + [
    f"n+1={r}_mod_16" for r in range(16)])
def test_walk_block_matches_plain(cuda_device, case):
    """Walks over a fill's codes or synthetic ones, against the plain walk:
    leaving tiles through their tops, lefts and corners, reaching column 0
    inside a tile, long thin pairs, m or n of 0 and 1, and n + 1 at every
    residue mod 16 (rows off 16-byte alignment every way)."""
    rng = np.random.default_rng(12)
    if case.startswith("n+1="):
        n = 31 + int(case[4:].split("_")[0])  # n + 1 = 32 + r
        shapes, levels, (i_entry, j_list) = [(45, n), (45, n)], None, (
            [45, 30], [n, n - 7])
    else:
        shapes, levels, (i_entry, j_list) = WALK_CASES[case]
    args = _case(rng, "ACGT", shapes)
    final3, moves = fill_cuda.batch_moves(*_on(cuda_device, args))
    level = final3.argmin(-1).to(torch.int32).cpu()
    if levels is not None:
        moves = _synthetic_codes(rng, levels, *shapes[0]).to(cuda_device)
        level = torch.tensor([max(levels[0], 0)], dtype=torch.int32)
    j_entry = torch.tensor(j_list, dtype=torch.int32)
    want = linear_tb.walk_block(moves.cpu(), i_entry, j_entry, level)
    before = linear_tb.walk_block.launches
    got = linear_tb.walk_block(
        moves, i_entry, j_entry.to(cuda_device), level.to(cuda_device)
    )
    torch.cuda.synchronize()
    assert linear_tb.walk_block.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("m,n", [(0, 5), (1, 0), (1, 9), (2, 2), (301, 280), (500, 0)])
def test_split_cost_matches_plain_and_direct(cuda_device, m, n):
    rng = np.random.default_rng(m + n)
    ta, tb, cost, gid, go, _, _ = _case(rng, "ACGT", [(m, n)])
    want = fill_split.split_fill_cost(ta[0], tb[0], cost, gid, go)
    before = fill_cuda.batch_last_rows.launches
    got = fill_split.split_fill_cost(
        ta[0].to(cuda_device), tb[0].to(cuda_device), cost.to(cuda_device), gid, go
    )
    assert fill_cuda.batch_last_rows.launches == before + 1
    direct, _ = fill_cuda.batch_moves(
        ta.to(cuda_device), tb.to(cuda_device), cost.to(cuda_device), gid, go,
        [m], [n], want_moves=False,
    )
    assert int(got) == int(want) == int(direct.min())


def test_blocked_align_matches_full_matrix(cuda_device):
    """A few hundred rows past a small budget: the blocked route on the card
    equals the full-matrix route and the CPU; so do 37-row blocks."""
    rng = np.random.default_rng(13)
    for letters, kw in (("ACGT", {}),
                        ("ARNDCQEGHILKMFPSTWYV", dict(scoring_mat_name="BLOSUM62"))):
        s1 = "".join(rng.choice(list(letters), 400))
        s2 = "".join(rng.choice(list(letters), 350))
        scheme = resolve_scheme(s1, s2, **kw)
        full = GotohAligner(scheme, device="cuda").align(s1, s2)
        small = GotohAligner(scheme, device="cuda", moves_budget_bytes=4096)
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        tiled = fill_tile.route(1, 400, 350, True, sms)  # the one replay
        before = (fill_cuda.batch_last_rows.launches,
                  fill_tile.gotoh_tile.launches, linear_tb.walk_block.launches)
        assert small.align(s1, s2) == full
        # the checkpoint pass: one gotoh_tile launch; the replay as routed
        assert (fill_cuda.batch_last_rows.launches,
                fill_tile.gotoh_tile.launches,
                linear_tb.walk_block.launches) == (
            before[0], before[1] + 1 + tiled, before[2] + 1
        )
        assert GotohAligner(scheme, device="cpu", moves_budget_bytes=4096).align(
            s1, s2
        ) == full
        enc = [small._encode(s) for s in (s1, s2)]
        tb37 = linear_tb.align_blocked(
            *enc, small.cost_mat, small.gap_id, small.gap_open, s1, s2,
            block_rows=37,
        )
        assert (tb37.seq_1_aligned, tb37.middle_part, tb37.seq_2_aligned,
                tb37.cost) == (full.seq_1_aligned, full.middle_part,
                               full.seq_2_aligned, full.cost)
        assert small.cost(s1, s2) == full.cost


# -- batch serving: gotoh_batch and align_pairs ------------------------------


@pytest.mark.parametrize(
    "letters,n_cols,scheme_kw",
    [
        ("ACGT", 1, {}),
        ("ACGT", 31, {}),
        ("ACGT", 33, {}),
        ("ACGT", 1023, {}),
        ("ACGT", 1024, {}),
        ("ARNDCQEGHILKMFPSTWYV", 255, dict(scoring_mat_name="BLOSUM62")),
        ("ACGT", 200, dict(match_score=3, mismatch_score=-2, gap_open_score=-5,
                           gap_extension_score=-1)),
    ],
)
def test_gotoh_batch_matches_plain(cuda_device, letters, n_cols, scheme_kw):
    """Ragged launches: a bucket of ``n_cols`` columns (m_true 0, 1 and M,
    zero and partial widths) beside buckets of other width classes; final3
    and the last rows at every column, kernel == plain, one launch a width
    class present."""
    rows = 40 if n_cols > 512 else 150
    shapes = [(rows, n_cols), (0, n_cols), (1, n_cols), (rows, n_cols // 2),
              (rows, 0), (rows // 3, max(1, n_cols - 5))]
    rng = np.random.default_rng(n_cols)
    buckets = [_case(rng, letters, shapes, **scheme_kw),
               _case(rng, letters, [(7, 600), (30, 129), (1, 1000)], **scheme_kw),
               _case(rng, letters, [(60, 100), (0, 3)], **scheme_kw)]
    args = ([b[0] for b in buckets], [b[1] for b in buckets], *buckets[0][2:5],
            [b[5] for b in buckets], [b[6] for b in buckets])
    on_card = ([t.to(cuda_device) for t in args[0]],
               [t.to(cuda_device) for t in args[1]], args[2].to(cuda_device),
               *args[3:])
    classes = {fill_batch.width_class(n) for b in buckets for n in b[6]}
    want3 = fill_batch.batch_final3_ragged(*args)
    want_last = fill_batch.batch_final3_ragged(*args, last_rows=True)
    before = fill_batch.batch_final3.launches
    got3 = fill_batch.batch_final3_ragged(*on_card)
    got_last = fill_batch.batch_final3_ragged(*on_card, last_rows=True)
    torch.cuda.synchronize()
    assert fill_batch.batch_final3.launches == before + 2 * len(classes)
    assert torch.equal(got3.cpu(), want3)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got_last, want_last))
    one = _on(cuda_device, buckets[0])  # the bucket alone: batch_final3
    assert torch.equal(fill_batch.batch_final3(*one).cpu(), want3[: len(shapes)])


@pytest.mark.parametrize("letters,shapes,tiled", [
    ("ACGT", [(30, 4200), (3, 4097)], False),  # wider than the cap
    ("ACGT", [(30, 1025), (3, 1000)], False),  # one column past it
    (TABLE_LETTERS, [(40, 400), (5, 9)], False),  # table, 10 columns a row
    (TABLE_LETTERS, [(40, 60), (5, 9)], True),  # table, the wide route
])
def test_batch_final3_past_the_plan_runs_gotoh_fill(cuda_device, letters, shapes,
                                                    tiled):
    """Buckets wider than gotoh_batch's 1024-column cap, or with a table
    too large for its shared memory, run gotoh_fill's final3 / last-row
    mode past 8 columns a row, and within it the wide route's one
    gotoh_tile launch (``fill_tile.route_buckets``)."""
    args = _case(np.random.default_rng(15), letters, shapes)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert bool(fill_tile.route_buckets([(args[5], args[6])], sms)) == tiled
    before = (fill_batch.batch_final3.launches, fill_cuda.batch_moves.launches,
              fill_cuda.batch_last_rows.launches, fill_tile.gotoh_tile.launches,
              fill_batch.batch_final3_ragged.wide_launches)
    got3 = fill_batch.batch_final3(*_on(cuda_device, args))
    got_last = fill_batch.batch_final3(*_on(cuda_device, args), last_rows=True)
    assert (fill_batch.batch_final3.launches, fill_cuda.batch_moves.launches,
            fill_cuda.batch_last_rows.launches, fill_tile.gotoh_tile.launches,
            fill_batch.batch_final3_ragged.wide_launches) == (
        before[0], before[1] + (not tiled), before[2] + (not tiled),
        before[3] + 2 * tiled, before[4] + 2 * tiled,
    )
    assert torch.equal(got3.cpu(), fill_batch.batch_final3(*args))
    assert torch.equal(got_last.cpu(), fill_batch.batch_final3(*args, last_rows=True))


@pytest.mark.parametrize("batch", [1, 33, 264])
def test_batch_final3_routing_on_either_side_of_the_cap(cuda_device, batch):
    """One ragged call over a bucket of 1024 columns and one of 1025: one
    gotoh_batch launch for the first, one gotoh_fill final3 launch for the
    second, at any batch size; final3 == plain."""
    rng = np.random.default_rng(batch)
    narrow = _case(rng, "ACGT", [(20, 1024)] * batch)
    wide = _case(rng, "ACGT", [(20, 1025)] * batch)
    args = ([narrow[0], wide[0]], [narrow[1], wide[1]], *narrow[2:5],
            [narrow[5], wide[5]], [narrow[6], wide[6]])
    on_card = ([t.to(cuda_device) for t in args[0]],
               [t.to(cuda_device) for t in args[1]], args[2].to(cuda_device),
               *args[3:])
    before = (fill_batch.batch_final3.launches, fill_cuda.batch_moves.launches)
    got = fill_batch.batch_final3_ragged(*on_card)
    assert (fill_batch.batch_final3.launches - before[0],
            fill_cuda.batch_moves.launches - before[1]) == (1, 1)
    assert torch.equal(got.cpu(), fill_batch.batch_final3_ragged(*args))


def _wide_tail_pairs(rng, letters):
    """A cost-only call with a wide tail: 60 pairs under 1024 columns and
    pairs past them in buckets of their own (one under 1024 rows, one of
    two pairs), within 8 columns a row."""
    def seq(k):
        return "".join(rng.choice(list(letters), k))

    pairs = [(seq(int(rng.integers(30, 600))), seq(int(rng.integers(30, 600))))
             for _ in range(60)]
    for m, n in ((1100, 1150), (2500, 2400), (900, 1300), (1700, 3100),
                 (1210, 1200), (1211, 1205), (4000, 3800)):
        pairs.insert(int(rng.integers(0, len(pairs))), (seq(m), seq(n)))
    return pairs


@pytest.mark.parametrize("letters,kw", [
    ("ACGT", {}), ("ARNDCQEGHILKMFPSTWYV", dict(scoring_mat_name="BLOSUM62")),
])
def test_align_pairs_cost_wide_tail_is_one_gotoh_tile_launch(cuda_device,
                                                             letters, kw,
                                                             monkeypatch):
    """A cost-only call's pairs past 1024 columns: one gotoh_tile launch
    over all of them (the counters say so) and no gotoh_fill launch; final3,
    costs and scores equal the per-bucket route's and the plain version's."""
    pairs = _wide_tail_pairs(np.random.default_rng(31), letters)
    wide = [(bucket_length(len(a)), bucket_length(len(b))) for a, b in pairs
            if bucket_length(len(b)) > fill_batch.MAX_COLUMNS]
    counters = lambda: (fill_tile.gotoh_tile.launches,  # noqa: E731
                        fill_cuda.batch_moves.launches,
                        fill_batch.batch_final3_ragged.wide_launches,
                        fill_batch.batch_final3_ragged.wide_pairs)
    before = counters()
    got = align_pairs(pairs, with_traceback=False, **kw)
    assert [a - b for a, b in zip(counters(), before)] == [1, 0, 1, len(wide)]
    with monkeypatch.context() as patch:  # each bucket on its own route
        patch.setattr(fill_tile, "route_buckets", lambda *a: [])
        before = counters()
        per_bucket = align_pairs(pairs, with_traceback=False, **kw)
        delta = [a - b for a, b in zip(counters(), before)]
    assert delta[0] + delta[1] == len(set(wide)) > 1 and delta[2:] == [0, 0]
    assert got == per_bucket == align_pairs(pairs, with_traceback=False,
                                            device="cpu", **kw)


def test_wide_route_makes_no_synchronising_call(cuda_device):
    """The cost fill over a call's buckets, wide ones included, queues its
    launches without a synchronising call (sync debug mode "error"), and
    its final3 equals the plain version's."""
    rng = np.random.default_rng(32)
    buckets = [_case(rng, "ACGT", shapes) for shapes in (
        [(300, 200), (120, 250)], [(1100, 1150)], [(2500, 2400), (2490, 2390)],
        [(900, 1300)])]
    args = ([b[0] for b in buckets], [b[1] for b in buckets], *buckets[0][2:5],
            [b[5] for b in buckets], [b[6] for b in buckets])
    on_card = ([t.to(cuda_device) for t in args[0]],
               [t.to(cuda_device) for t in args[1]], args[2].to(cuda_device),
               *args[3:])
    fill_batch.batch_final3_ragged(*on_card)  # the build, the card's SMs
    torch.cuda.synchronize()
    before = fill_batch.batch_final3_ragged.wide_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fill_batch.batch_final3_ragged(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fill_batch.batch_final3_ragged.wide_launches == before + 1
    assert torch.equal(got.cpu(), fill_batch.batch_final3_ragged(*args))


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("letters,kw", [
    ("ACGT", {}), ("ARNDCQEGHILKMFPSTWYV", dict(scoring_mat_name="BLOSUM62")),
])
def test_align_pairs_on_the_card_matches_cpu(cuda_device, letters, kw,
                                             with_traceback):
    """Ragged pairs over several buckets: the card (cost-only, one
    gotoh_batch launch a width class; traceback, one gotoh_batch_moves
    launch a width class and one ragged walk) == ``device="cpu"``, pair by
    pair; flush=False too."""
    rng = np.random.default_rng(16 + with_traceback)
    pairs = [
        tuple("".join(rng.choice(list(letters), int(rng.integers(1, 200))))
              for _ in range(2))
        for _ in range(40)
    ]
    buckets = {(bucket_length(len(a)), bucket_length(len(b))) for a, b in pairs}
    classes = {fill_batch.width_class(len(b)) for _, b in pairs}
    launch_classes = fill_cuda.ragged_classes(
        [len(a) for a, _ in pairs], [len(b) for _, b in pairs],
        torch.cuda.get_device_properties(cuda_device).multi_processor_count,
    )
    counters = (fill_batch.batch_final3, fill_cuda.batch_moves,
                linear_tb.walk_block, fill_cuda.batch_moves_ragged,
                linear_tb.walk_ragged, fill_batch.batch_moves_warp)
    before = [fn.launches for fn in counters]
    got = align_pairs(pairs, with_traceback=with_traceback, **kw)
    assert len(buckets) > 1 and launch_classes
    assert [fn.launches - k for fn, k in zip(counters, before)] == (
        [0, 0, 0, 0, 1, len(classes)] if with_traceback
        else [len(classes), 0, 0, 0, 0, 0]
    )
    want = align_pairs(pairs, with_traceback=with_traceback, device="cpu", **kw)
    assert got == want
    assert align_pairs(pairs, with_traceback=with_traceback, flush=False,
                       **kw).resolve() == want


@pytest.mark.parametrize("letters,kw", [
    ("ACGT", {}), ("ARNDCQEGHILKMFPSTWYV", dict(scoring_mat_name="BLOSUM62")),
])
@pytest.mark.parametrize("placed", [False, True])
def test_ragged_fill_and_walk_match_plain(cuda_device, letters, kw, placed):
    """The ragged moves fill and walk on the card against their plain
    versions: pairs on both routes (gotoh_batch_moves up to 1024 columns;
    gotoh_fill's launch classes past it, a pair over a cluster of 8 bands
    in two passes; m_true / n_true 0 and 1), packed in order or placed with
    gaps out of pair order; final3, every pair's codes, tapes, counts and
    exit columns equal, one launch a width class or launch class and one
    walk launch."""
    rng = np.random.default_rng(61 + placed)
    shapes = [[(40, 33_000), (3, 5000)], [(1, 1), (0, 7), (9, 0)],
              [(200, 300), (1, 290), (250, 1)], [(64, 2100)]]
    buckets = [_case(rng, letters, sh, **kw) for sh in shapes]
    shared = buckets[0][2:5]
    args = ([b[0] for b in buckets], [b[1] for b in buckets], *shared,
            [b[5] for b in buckets], [b[6] for b in buckets])
    m = [x for b in buckets for x in b[5]]
    n = [x for b in buckets for x in b[6]]
    size = fill_cuda.ragged_bytes(np.array(m), np.array(n))
    place = {}
    if placed:  # with gaps, out of pair order, at multiples of 16
        order = rng.permutation(len(m))
        offsets = np.zeros(len(m), np.int64)
        offsets[order] = np.cumsum(np.concatenate([[16], size[order][:-1] + 48]))
        place = dict(offsets=offsets, nbytes=int((offsets + size).max()) + 9)
    want = fill_cuda.batch_moves_ragged(*args, **place)
    warp, classes, _ = fill_cuda.ragged_routes(
        m, n, shared[0].shape[0],
        torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    counters = (fill_batch.batch_moves_warp, fill_cuda.batch_moves_ragged,
                linear_tb.walk_ragged)
    before = [fn.launches for fn in counters]
    got = fill_cuda.batch_moves_ragged(
        [t.to(cuda_device) for t in args[0]], [t.to(cuda_device) for t in args[1]],
        shared[0].to(cuda_device), *shared[1:], *args[5:], **place)
    got_walk = linear_tb.walk_ragged(got)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counters, before)] == [
        len(warp), len(classes), 1]
    assert any(lp.bands > 1 and lp.passes > 1 for lp, _ in classes) and warp
    assert torch.equal(got.final3.cpu(), want.final3)
    codes, want_codes = got.codes.cpu(), want.codes
    for row in want.layout.tolist():
        lo, hi = row[4], row[4] + (row[2] + 1) * row[5]
        assert torch.equal(codes[lo:hi], want_codes[lo:hi])
    for g, w in zip(got_walk, linear_tb.walk_ragged(want)):
        assert torch.equal(g.cpu(), w)


UNICODE_MTX = (  # a matrix over three non-ASCII letters and A
    "Ω Ж 字 A -\n"
    "Ω 4 -2 -3 -1 -3\n"
    "Ж -2 5 -1 -3 -3\n"
    "字 -3 -1 4 -2 -3\n"
    "A -1 -3 -2 5 -3\n"
    "- -3 -3 -3 -3 4\n"
)
WARP_SHAPES = [  # every width class and its edges, m or n of 0 and 1
    (37, 1), (1, 31), (40, 32), (33, 33), (0, 5), (5, 0), (0, 0), (1, 1),
    (90, 127), (2, 128), (129, 129), (60, 255), (256, 256), (17, 257),
    (11, 511), (300, 512), (9, 513), (45, 1023), (1024, 1024), (1, 1024),
    (1024, 1),
]


@pytest.mark.parametrize("alphabet", ["dna", "blosum62", "unicode"])
def test_batch_moves_warp_matches_plain(cuda_device, tmp_path, alphabet):
    """gotoh_batch_moves (the ragged moves fill up to 1024 columns) against
    the plain row scan at tolerance 0 over every width class and its edges,
    m or n of 0 and 1, in three alphabets: final3 and every byte of each
    pair's rows (column 0, the bytes past n, row 0); one launch a width
    class and no gotoh_fill launch; the walk over its codes equal to the
    plain walk."""
    if alphabet == "unicode":
        mtx = tmp_path / "unicode.mtx"
        mtx.write_text(UNICODE_MTX, encoding="utf-8")
        letters, kw = "ΩЖ字A", dict(scoring_mat_path=mtx)
    else:
        letters, kw = {"dna": ("ACGT", {}), "blosum62": (
            "ARNDCQEGHILKMFPSTWYV", dict(scoring_mat_name="BLOSUM62"))}[alphabet]
    rng = np.random.default_rng(70 + len(alphabet))
    order = rng.permutation(len(WARP_SHAPES))
    buckets = [_case(rng, letters, [WARP_SHAPES[k] for k in order[lo : lo + 7]],
                     **kw) for lo in (0, 7, 14)]
    shared = buckets[0][2:5]
    args = ([b[0] for b in buckets], [b[1] for b in buckets], *shared,
            [b[5] for b in buckets], [b[6] for b in buckets])
    n = [x for b in buckets for x in b[6]]
    want = fill_cuda.batch_moves_ragged(*args)
    counters = (fill_batch.batch_moves_warp, fill_cuda.batch_moves_ragged)
    before = [fn.launches for fn in counters]
    got = fill_cuda.batch_moves_ragged(
        [t.to(cuda_device) for t in args[0]], [t.to(cuda_device) for t in args[1]],
        shared[0].to(cuda_device), *shared[1:], *args[5:])
    got_walk = linear_tb.walk_ragged(got)
    torch.cuda.synchronize()
    widths = {fill_batch.width_class(x) for x in n}
    assert [fn.launches - k for fn, k in zip(counters, before)] == [len(widths), 0]
    assert torch.equal(got.final3.cpu(), want.final3)
    codes = got.codes.cpu()
    for row in want.layout.tolist():
        lo, hi = row[4], row[4] + (row[2] + 1) * row[5]
        assert torch.equal(codes[lo:hi], want.codes[lo:hi]), row[2:4]
    for g, w in zip(got_walk, linear_tb.walk_ragged(want)):
        assert torch.equal(g.cpu(), w)


def test_batch_moves_ragged_mixes_both_routes(cuda_device):
    """One call with pairs on both sides of 1024 columns: a gotoh_batch_moves
    launch a width class and a gotoh_fill ragged launch a launch class into
    one buffer, equal to the plain version byte for byte, walked by one
    walk_ragged launch."""
    rng = np.random.default_rng(83)
    buckets = [_case(rng, "ACGT", sh) for sh in (
        [(30, 1025), (5, 100)], [(40, 2000), (20, 900), (64, 1024)])]
    shared = buckets[0][2:5]
    args = ([b[0] for b in buckets], [b[1] for b in buckets], *shared,
            [b[5] for b in buckets], [b[6] for b in buckets])
    m = [x for b in buckets for x in b[5]]
    n = [x for b in buckets for x in b[6]]
    warp, classes, _ = fill_cuda.ragged_routes(
        m, n, 5, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert [w for w, _ in warp] == [4, 32] and classes
    want = fill_cuda.batch_moves_ragged(*args)
    counters = (fill_batch.batch_moves_warp, fill_cuda.batch_moves_ragged,
                linear_tb.walk_ragged)
    before = [fn.launches for fn in counters]
    got = fill_cuda.batch_moves_ragged(
        [t.to(cuda_device) for t in args[0]], [t.to(cuda_device) for t in args[1]],
        shared[0].to(cuda_device), *shared[1:], *args[5:])
    got_walk = linear_tb.walk_ragged(got)
    torch.cuda.synchronize()
    assert [fn.launches - k for fn, k in zip(counters, before)] == [
        len(warp), len(classes), 1]
    assert torch.equal(got.final3.cpu(), want.final3)
    assert torch.equal(got.codes.cpu(), want.codes)
    for g, w in zip(got_walk, linear_tb.walk_ragged(want)):
        assert torch.equal(g.cpu(), w)


def _split_call(rng, letters, kw):
    """A ragged set on both routes: 6 narrow pairs (gotoh_batch_moves) and
    one gotoh_fill launch class of 5 pairs of 1934-2048 columns (W 4, 2
    warps, 8 bands, 1 pass at 132 SMs) and 300-2000 rows, in two buckets."""
    narrow = [(int(rng.integers(1, 300)), int(rng.integers(1, 1000)))
              for _ in range(6)]
    wide = [(300, 1950), (2000, 2048), (1200, 1999), (700, 1934), (1500, 2011)]
    return _ragged_args([_case(rng, letters, narrow[:3] + wide[:2], **kw),
                         _case(rng, letters, narrow[3:] + wide[2:], **kw)])


def _split_counts():
    return (fill_batch.batch_moves_warp.launches,
            fill_cuda.batch_moves_ragged.launches,
            fill_cuda.batch_moves_ragged.wide_pairs,
            fill_tile.gotoh_tile.launches,
            fill_cuda.batch_moves_ragged.tile_launches,
            fill_cuda.batch_moves_ragged.tile_pairs)


@pytest.mark.parametrize("letters,kw", [("ACGT", {}), (PROTEIN, BLOSUM)])
def test_a_split_launch_class_matches_plain(cuda_device, monkeypatch, letters,
                                            kw):
    """A call on both routes whose gotoh_fill launch class of 5 pairs is
    forced to split (the cluster query patched to 4: the smallest pair
    goes to gotoh_tile, on the side stream): a gotoh_batch_moves launch a
    width class, one gotoh_fill launch of 4 and one gotoh_tile launch of 1;
    final3, every pair's region of the buffer (packed, and placed with
    gaps out of pair order) and the walk equal the plain versions."""
    rng = np.random.default_rng(91 + len(letters))
    args = _split_call(rng, letters, kw)
    m = [x for ms in args[5] for x in ms]
    n = [x for ns in args[6] for x in ns]
    warp, classes, tiles = fill_cuda.ragged_routes(
        m, n, args[2].shape[0], _sms(cuda_device), lambda lp: 4)
    assert len(classes) == 1 and [len(t) for t in tiles] == [1]
    assert m[int(tiles[0][0])] == 300
    monkeypatch.setattr(fill_cuda, "_clusters", lambda index, alphabet, lp: 4)
    for place in ({}, _placed(rng, args)):
        want = fill_cuda.batch_moves_ragged(*args, **place)
        before = _split_counts()
        got = fill_cuda.batch_moves_ragged(*_ragged_on(cuda_device, args), **place)
        got_walk = linear_tb.walk_ragged(got)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_split_counts(), before)] == [
            len(warp), 1, 4, 1, 1, 1]
        _assert_ragged_equal(got, want)
        if not place:
            assert torch.equal(got.codes.cpu(), want.codes)
        for g, w in zip(got_walk, linear_tb.walk_ragged(want)):
            assert torch.equal(g.cpu(), w)


def test_split_class_makes_no_synchronising_call(cuda_device, monkeypatch):
    """The ragged moves fill with a class split (the cluster query patched
    to 4) queues its gotoh_fill launch, the side stream's gotoh_tile launch
    and the joins without a synchronising call (sync debug mode "error"),
    and equals the plain version."""
    args = _split_call(np.random.default_rng(95), "ACGT", {})
    monkeypatch.setattr(fill_cuda, "_clusters", lambda index, alphabet, lp: 4)
    on_card = _ragged_on(cuda_device, args)
    fill_cuda.batch_moves_ragged(*on_card)  # the build, the card's SMs
    torch.cuda.synchronize()
    before = fill_cuda.batch_moves_ragged.tile_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fill_cuda.batch_moves_ragged(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fill_cuda.batch_moves_ragged.tile_launches == before + 1
    _assert_ragged_equal(got, fill_cuda.batch_moves_ragged(*args))


def test_align_pairs_genomes_match_the_reference(cuda_device):
    """Three pairs of 29 903 nt from the genome cell's traffic
    (``benchmark/traffic/sars2_genomes_tb.json``) under its scheme, BLAST+'s
    blastn, in one traceback call: one segment (their 2.7 GB of codes pass
    the moves budget but not the segment capacity, a quarter of the card),
    one ``gotoh_fill`` ragged launch over the three wide pairs, and costs,
    scores and the three lines equal to the benchmark's plain reference on
    the card."""
    import json
    from pathlib import Path

    from benchmark.harness import traffic
    from benchmark.reference import gotoh, scheme
    from globalign_tpu_torch import align_pairs, batch

    bench = Path(__file__).resolve().parents[1] / "benchmark"
    mix = json.loads((bench / "traffic" / "sars2_genomes_tb.json").read_text())
    kw = json.loads((bench / "configs" / "sars2_blastn.json").read_text())["scheme"]
    (pairs,) = traffic.generate({**mix, "pool_calls": 1, "pairs_per_call": 3},
                                "ACGT", 2 ** 31 + 19)
    counters = lambda: (batch.align_pairs.segments,  # noqa: E731
                        fill_cuda.batch_moves_ragged.wide_launches,
                        fill_cuda.batch_moves_ragged.wide_pairs)
    before = counters()
    got = align_pairs(pairs, **kw)
    assert [a - b for a, b in zip(counters(), before)] == [1, 1, 3]
    want = gotoh.align(pairs, scheme.resolve(kw, "ACGT"), traceback=True,
                       device=cuda_device, budget_bytes=8 << 30)
    assert [(r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
            for r in got] == want


def _strip_case(rng, letters, rb, width, **scheme_kw):
    """A block of ``rb`` rows under a real checkpoint row, cut into a left
    strip of 37 columns (at the matrix edge) and a strip of ``width``
    columns whose col0 is the left strip's edge (from the plain version)."""
    from globalign_tpu_torch.ops import fill_rows
    from globalign_tpu_torch.ops.fill_scan import BIG

    scheme = resolve_scheme(letters, letters, **scheme_kw)
    cm = torch.from_numpy(np.ascontiguousarray(scheme.costing.values, dtype=np.int32))
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost

    def enc(k):
        seq = "".join(rng.choice(list(letters), k))
        return torch.tensor([0, *scheme.alphabet.encode(seq)], dtype=torch.int32)

    i0, left = 5, 37
    ta_full, tb_full = enc(i0 + rb), enc(left + width)
    top = fill_rows.row_fill(ta_full[: i0 + 1], tb_full, cm, gid, go,
                             want_moves=False).last3
    steps = cm[ta_full[i0:], gid].clone()
    steps[0] = 0
    edge0 = torch.stack([torch.full((rb + 1,), BIG, dtype=torch.int32)] * 2 + [
        int(top[2, 0]) + torch.cumsum(steps, 0, dtype=torch.int32)])
    ta = ta_full[i0:].clone()
    ta[0] = 0
    left_args = (ta[None], tb_full[None, : left + 1].contiguous(), cm, gid, go,
                 top[None, :, : left + 1].contiguous(), edge0[None])
    _, edge = fill_cuda.strip_fill_block(*left_args, [rb])
    tb = torch.cat([torch.zeros(1, dtype=torch.int32), tb_full[left + 1 :]])
    right_args = (ta[None], tb[None], cm, gid, go,
                  top[None, :, left:].contiguous(), edge)
    return left_args, right_args


@pytest.mark.parametrize("rb,width", [(1, 1), (5, 0), (3, 31), (1, 1024),
                                      (17, 1024), (64, 13_000), (3, 16_000),
                                      (256, 16_000), (256, 50_000)])
@pytest.mark.parametrize("letters,scheme_kw", [
    ("ACGT", {}), (PROTEIN, BLOSUM), ("ACGT", ODD), (WIDE, WIDE_KW),
])
def test_strip_mode_matches_plain(cuda_device, rb, width, letters, scheme_kw):
    """``gotoh_fill``'s strip mode (TPU kernel #10) == its plain version:
    fin and edge, at the matrix edge and beside a neighbour strip, m_true
    = 0, short of the block and the whole block; one launch a call."""
    rng = np.random.default_rng(rb + width)
    for args in _strip_case(rng, letters, rb, width, **scheme_kw):
        for m_true in sorted({0, max(0, rb - 2), rb}):
            want = fill_cuda.strip_fill_block(*args, [m_true])
            before = fill_cuda.strip_fill_block.launches
            got = fill_cuda.strip_fill_block(*_on(cuda_device, args[:3]),
                                             *args[3:5],
                                             *(x.to(cuda_device) for x in args[5:]),
                                             [m_true])
            torch.cuda.synchronize()
            assert fill_cuda.strip_fill_block.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (rb, width, m_true)


def test_strip_mode_rejects_codes_and_mixed_devices(cuda_device):
    rng = np.random.default_rng(2)
    _, (ta, tb, cm, gid, go, row0, col0) = _strip_case(rng, "ACGT", 4, 9)
    dev = cuda_device
    with pytest.raises(ValueError, match="is on cpu"):
        fill_cuda.strip_fill_block(ta.to(dev), tb.to(dev), cm.to(dev), gid, go,
                                   row0.to(dev), col0, [4])


@pytest.fixture
def world_of_one(cuda_device):
    """One NCCL rank on the card — the production mesh on one H100."""
    import torch.distributed as dist

    from globalign_tpu_torch.parallel import make_pair_mesh, multihost

    multihost.initialize(num_processes=1)
    try:
        yield make_pair_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("with_traceback", [False, True])
def test_world_of_one_align_pairs_equals_no_mesh(world_of_one, with_traceback):

    assert world_of_one.backend == "nccl"
    rng = np.random.default_rng(23)
    pairs = [tuple("".join(rng.choice(list("ACGT"), int(rng.integers(1, 300))))
                   for _ in range(2)) for _ in range(37)]
    want = align_pairs(pairs, with_traceback=with_traceback)
    assert align_pairs(pairs, with_traceback=with_traceback,
                       mesh=world_of_one) == want


def test_world_of_one_pair_cost_launches_the_strip_mode(world_of_one):
    """Every block of the sequence-parallel fill is one strip-mode launch."""
    from globalign_tpu_torch.parallel import seqpar

    rng = np.random.default_rng(5)
    s1, s2 = ("".join(rng.choice(list("ACGT"), k)) for k in (1000, 1700))
    aligner = GotohAligner(resolve_scheme(s1, s2), device="cuda")
    enc = (aligner._encode(s1), aligner._encode(s2), aligner.cost_mat,
           aligner.gap_id, aligner.gap_open)
    before = fill_cuda.strip_fill_block.launches
    got = seqpar.sharded_pair_cost(world_of_one, *enc, block_rows=128)
    assert fill_cuda.strip_fill_block.launches - before == -(-1000 // 128)
    assert int(got.min()) == aligner.cost(s1, s2)


# -- the wave kernel (TPU kernel #9) and the dual-set batch fill (#11) ------


WAVE_SCHEMES = [
    {},  # the default DNA scheme: the JAX bench's wave arm (bench.py:244-251)
    ODD,  # dcost != icost
    # the JAX bench's other uniform schemes
    dict(mismatch_cost=1, gap_open_cost=7, gap_extension_cost=1),
    dict(mismatch_cost=9, gap_open_cost=2, gap_extension_cost=6),
]


def _wave_case(rng, m, n, pad=(0, 0), **scheme_kw):
    """Seeded DNA tokens (padded past m / n) and the scheme's uniform costs."""
    scheme = resolve_scheme("ACGT", "ACGT", **scheme_kw)
    cm = np.asarray(scheme.costing.values, np.int32)
    prm = fill_wave.uniform_scheme_params(cm, scheme.alphabet.gap_id)
    ta = np.zeros(m + 1 + pad[0], np.int32)
    tb = np.zeros(n + 1 + pad[1], np.int32)
    ta[1:] = rng.integers(0, 4, m + pad[0])
    tb[1:] = rng.integers(0, 4, n + pad[1])
    return (torch.from_numpy(ta), torch.from_numpy(tb), *prm,
            scheme.gap_open_cost, m, n), (torch.from_numpy(cm), scheme)


@pytest.mark.parametrize("m,n,pad", [
    (0, 0, (0, 0)), (0, 1, (2, 0)), (1, 0, (0, 3)), (1, 1, (0, 0)),
    (2, 70, (5, 1)), (70, 2, (0, 0)), (1023, 1025, (0, 0)),
    (1025, 1023, (7, 9)),
    # tile edges: m, n = k H +- 1 and k 32 W +- 1 (H = 32 W = 128)
    (127, 129, (0, 0)), (129, 127, (2, 1)), (255, 257, (0, 0)),
    (257, 383, (1, 0)), (385, 255, (0, 3)),
    # lopsided: one tile column, one tile row, and many of each
    (3000, 129, (0, 0)), (127, 2049, (0, 4)), (2100, 900, (0, 0)),
    (13_000, 40, (3, 0)), (127, 3000, (0, 0)), (640, 640, (0, 0)),
])
@pytest.mark.parametrize("scheme_kw", WAVE_SCHEMES[:2])
def test_wave_kernel_matches_plain(cuda_device, m, n, pad, scheme_kw):
    """All four captured waves at every row, and the cost: kernel == plain,
    m + n <= 1 included, one launch a call; the cost also equals the
    direct fill."""
    args, (cm, scheme) = _wave_case(np.random.default_rng(m * 7 + n), m, n, pad,
                                    **scheme_kw)
    on_card = (args[0].to(cuda_device), args[1].to(cuda_device), *args[2:])
    want = fill_wave.wave_frontiers(*args)
    before = fill_wave.wave_frontiers.launches
    got = fill_wave.wave_frontiers(*on_card)
    cost = fill_wave.wave_split_fill_cost(*on_card)
    torch.cuda.synchronize()
    assert fill_wave.wave_frontiers.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert int(cost) == int(fill_wave.join_frontiers(want, args[6], m, n))
    direct, _ = fill_cuda.batch_moves(
        args[0][None], args[1][None], cm, scheme.alphabet.gap_id,
        scheme.gap_open_cost, [m], [n], want_moves=False,
    )
    assert int(cost) == int(direct.min())


@pytest.mark.parametrize("m,n,pad,scheme", [
    (m, n, pad, k) for k in (0, 1)
    for m, n, pad in ((4096, 4096, (0, 0)), (12_345, 3000, (7, 7)))
] + [
    (m, n, pad, k) for k in (2, 3)
    for m, n, pad in ((0, 0, (0, 0)), (0, 1, (2, 0)), (1, 0, (0, 3)),
                      (1, 1, (0, 0)), (2, 70, (5, 1)), (70, 2, (0, 0)),
                      (1023, 1025, (0, 0)), (127, 129, (0, 0)),
                      (255, 257, (0, 0)), (385, 255, (0, 3)),
                      (640, 640, (0, 0)), (4096, 4096, (0, 0)),
                      (12_345, 3000, (7, 7)))
])
def test_wave_kernel_matches_plain_at_long_sizes_and_more_schemes(
        cuda_device, m, n, pad, scheme):
    """The long pairs' sizes, and the JAX bench's other uniform schemes from
    m + n <= 1 over the plan's tile edges to 12 345 x 3000: all four captured
    waves at every row and the cost, kernel == plain, one launch a call."""
    args, _ = _wave_case(np.random.default_rng(m + n), m, n, pad,
                         **WAVE_SCHEMES[scheme])
    on_card = (args[0].to(cuda_device), args[1].to(cuda_device), *args[2:])
    want = fill_wave.wave_frontiers(*args)
    before = fill_wave.wave_frontiers.launches
    got = fill_wave.wave_frontiers(*on_card)
    cost = fill_wave.wave_split_fill_cost(*on_card)
    torch.cuda.synchronize()
    assert fill_wave.wave_frontiers.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert int(cost) == int(fill_wave.join_frontiers(want, args[6], m, n))


def test_wave_kernel_rejects_mixed_devices(cuda_device):

    args, _ = _wave_case(np.random.default_rng(3), 5, 7)
    before = fill_wave.wave_frontiers.launches
    with pytest.raises(ValueError, match="is on"):
        fill_wave.wave_frontiers(args[0].to(cuda_device), *args[1:])
    with pytest.raises(ValueError, match="is on"):
        fill_wave.wave_split_fill_cost(args[0], args[1].to(cuda_device), *args[2:])
    assert fill_wave.wave_frontiers.launches == before


def _dual_case(rng, letters, batch, n_cols, **scheme_kw):
    """Two sets of ``batch`` ragged pairs of up to 40 x n_cols."""
    shapes = [(int(rng.integers(0, 41)), int(rng.integers(0, n_cols + 1)))
              for _ in range(2 * batch)]
    shapes[0] = (40, n_cols)
    ta, tb, cost, gid, go, mt, nt = _case(rng, letters, shapes, **scheme_kw)
    return (ta.reshape(2, batch, -1), tb.reshape(2, batch, -1), cost, gid, go,
            np.reshape(mt, (2, batch)), np.reshape(nt, (2, batch)))


@pytest.mark.parametrize("batch,n_cols", [(1, 1), (33, 64), (5, 1024), (4, 5000)])
@pytest.mark.parametrize("letters,scheme_kw", [
    ("ACGT", {}), ("ARNDCQEGHILKMFPSTWYV", dict(scoring_mat_name="BLOSUM62")),
])
def test_batch_final3_dual_matches_plain(cuda_device, batch, n_cols, letters,
                                         scheme_kw):
    """Both sets in one call (a gotoh_batch launch a width class, or one
    gotoh_fill launch), on either side of gotoh_batch's 1024-column cap,
    equal to the plain version and to two single-set calls."""
    args = _dual_case(np.random.default_rng(batch + n_cols), letters, batch,
                      n_cols, **scheme_kw)
    want = fill_batch.batch_final3_dual(*args)
    on_card = (args[0].to(cuda_device), args[1].to(cuda_device),
               args[2].to(cuda_device), *args[3:])
    before = fill_batch.batch_final3.launches + fill_cuda.batch_moves.launches
    got = fill_batch.batch_final3_dual(*on_card)
    torch.cuda.synchronize()
    design = 1 if n_cols > fill_batch.MAX_COLUMNS else len(
        {fill_batch.width_class(int(n)) for n in np.ravel(args[6])})
    assert fill_batch.batch_final3.launches + fill_cuda.batch_moves.launches == (
        before + design
    )
    assert torch.equal(got.cpu(), want)
    for s in range(2):
        single = fill_batch.batch_final3(on_card[0][s], on_card[1][s],
                                         *on_card[2:5], args[5][s], args[6][s])
        assert torch.equal(single.cpu(), want[s])


def test_batch_final3_dual_rejects_mixed_devices(cuda_device):

    args = _dual_case(np.random.default_rng(4), "ACGT", 3, 50)
    with pytest.raises(ValueError, match="is on"):
        fill_batch.batch_final3_dual(args[0].to(cuda_device),
                                     args[1].to(cuda_device), *args[2:])


# -- gotoh_tile: one pair's fill over the whole card -------------------------


def _tile_shapes(height, width):
    """Pairs at a tile shape's edges: k H +- 1 rows, k 32 W +- 1 columns,
    m or n of 0 and 1, and two pairs of different shapes in one launch."""
    cols = 32 * width
    return [
        [(height - 1, cols - 1)], [(height, cols)], [(height + 1, cols + 1)],
        [(2 * height + 1, 3 * cols - 1)], [(3 * height - 1, 2 * cols + 1)],
        [(1, 1)], [(1, 3 * cols + 1)], [(3 * height + 1, 1)], [(0, 5)],
        [(5, 0)], [(0, 0)],
        [(2 * height + 1, cols + 1), (height - 1, 2 * cols + 3)],
    ]


def _assert_tile_equals_plain(dev, args, shape, rows=None, **inj):
    """gotoh_tile on the card == its plain version, one launch a call:
    final3, codes, and the rows (the last row by default)."""
    rows = rows or [[m] for m in args[5]]
    dev_inj = {k: v.to(dev) for k, v in inj.items()}
    for want_moves in (True, False):
        want = fill_tile.gotoh_tile(*args, want_moves=want_moves, rows=rows,
                                    **inj)
        before = fill_tile.gotoh_tile.launches
        got = fill_tile.gotoh_tile(*_on(dev, args), want_moves=want_moves,
                                   rows=rows, shape=shape, **dev_inj)
        torch.cuda.synchronize()
        assert fill_tile.gotoh_tile.launches == before + 1
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g.cpu(), w), (shape, args[5], args[6])


@pytest.mark.parametrize("shape", fill_tile.SHAPES)
@pytest.mark.parametrize("letters,scheme_kw", [
    ("ACGT", {}), (PROTEIN, BLOSUM), ("ACGT", dict(gap_open_cost=0)),
    (WIDE, WIDE_KW),
])
def test_gotoh_tile_matches_plain_at_its_tile_edges(cuda_device, shape,
                                                    letters, scheme_kw):
    """Every (H, W) instance at its tile edges, B = 1 and 2: final3, every
    code, the last row; and the same fills injected below row m // 2."""
    height, width = shape
    for k, shapes in enumerate(_tile_shapes(height, width)):
        rng = np.random.default_rng(100 * height + 10 * width + k)
        args = _case(rng, letters, shapes, **scheme_kw)
        _assert_tile_equals_plain(cuda_device, args, shape)
        blk, top, c0 = _checkpointed(args, [m // 2 for m in args[5]])
        _assert_tile_equals_plain(cuda_device, blk, shape, row0=top,
                                  col0y_top=c0)


@pytest.mark.parametrize("shape", fill_tile.SHAPES)
def test_gotoh_tile_checkpoint_rows_match_plain(cuda_device, shape):
    """Lists of rows (0, 1, every tile row's edges, m) from one launch,
    plain and injected, equal the row scan block by block."""
    height, _ = shape
    rng = np.random.default_rng(height)
    args = _case(rng, "ACGT", [(5 * height + 3, 700)])
    m = args[5][0]
    lists = [[m], [0, m], [1, height - 1, height, height + 1, m - 1, m],
             list(range(1, m + 1, 37)) + [m], list(range(0, m + 1))]
    for rows in lists:
        _assert_tile_equals_plain(cuda_device, args, shape, rows=[rows])
    blk, top, c0 = _checkpointed(args, [height + 7])
    _assert_tile_equals_plain(cuda_device, blk, shape,
                              rows=[[1, height, blk[5][0]]], row0=top,
                              col0y_top=c0)


def test_gotoh_tile_takes_a_table_in_global_memory(cuda_device):
    """A 400-letter alphabet: its table does not fit in shared memory."""
    rng = np.random.default_rng(16)
    letters = "".join(chr(0x4E00 + k) for k in range(399))
    for shape in fill_tile.SHAPES:
        _assert_tile_equals_plain(cuda_device, _case(rng, letters, [(70, 300)]),
                                  shape)


def _placed(rng, args, gap=48):
    """``batch_moves_ragged``'s ``offsets`` / ``nbytes`` placing a ragged
    set's pairs with gaps, out of pair order, at multiples of 16."""
    m = [x for ms in args[5] for x in ms]
    n = [x for ns in args[6] for x in ns]
    size = fill_cuda.ragged_bytes(np.array(m), np.array(n))
    order = rng.permutation(len(m))
    offsets = np.zeros(len(m), np.int64)
    offsets[order] = np.cumsum(np.concatenate([[16], size[order][:-1] + gap]))
    return dict(offsets=offsets, nbytes=int((offsets + size).max()) + 9)


def _assert_tile_codes_equal(dev, args, place, shape=None):
    """One ``fill_tile.launch_codes`` launch over every pair of a ragged set
    (``batch_moves_ragged``'s arguments, placed by ``place``) into a buffer
    of 0xAB bytes == the plain ragged fill: final3 and every byte of each
    pair's region; the bytes outside the regions keep their 0xAB."""
    want = fill_cuda.batch_moves_ragged(*args, **place)
    tas, tbs, cost, gid, go, mts, nts = _ragged_on(dev, args)
    _, lengths = fill_cuda._check_buckets(tas, tbs, cost, gid, mts, nts)
    layout, nbytes = fill_cuda._ragged_layout(tas, tbs, lengths, place["offsets"],
                                              place["nbytes"])
    codes = torch.full((nbytes,), 0xAB, dtype=torch.uint8, device=dev)
    final3 = torch.full((len(layout), 3), -7, dtype=torch.int32, device=dev)
    before = fill_tile.gotoh_tile.launches
    fill_tile.launch_codes(layout, codes, final3, cost, gid, go, shape=shape)
    torch.cuda.synchronize()
    assert fill_tile.gotoh_tile.launches == before + 1
    assert torch.equal(final3.cpu(), want.final3)
    region = torch.zeros(nbytes, dtype=torch.bool, device=dev)
    for row in want.layout.tolist():
        lo, hi = row[4], row[4] + (row[2] + 1) * row[5]
        assert torch.equal(codes[lo:hi].cpu(), want.codes[lo:hi]), row[2:4]
        region[lo:hi] = True
    assert bool(torch.where(region, 0xAB, codes).eq(0xAB).all())


@pytest.mark.parametrize("shape", fill_tile.SHAPES)
@pytest.mark.parametrize("letters,scheme_kw", [
    ("ACGT", {}), (PROTEIN, BLOSUM), (WIDE, WIDE_KW),
])
def test_gotoh_tile_codes_into_a_ragged_fill_at_its_tile_edges(
        cuda_device, shape, letters, scheme_kw):
    """gotoh_tile with codes at a ragged fill's byte offsets and row
    strides (``fill_tile.launch_codes``), every (H, W) instance, one launch
    over pairs at its tile edges (k H +- 1 rows, k 32 W +- 1 columns, m or
    n of 0 and 1) and with n + 1 at every residue mod 16, placed with gaps
    out of pair order: final3 and each pair's region equal the plain ragged
    fill byte for byte, and no byte outside the regions is written."""
    height, width = shape
    cols = 32 * width
    shapes = [sh for group in _tile_shapes(height, width) for sh in group]
    shapes += [(height + 3 * k, cols + k) for k in range(16)]
    assert {(n + 1) % 16 for _, n in shapes} == set(range(16))
    rng = np.random.default_rng(7 * height + width + len(letters))
    args = _ragged_args([_case(rng, letters, shapes[k : k + 5], **scheme_kw)
                         for k in range(0, len(shapes), 5)])
    _assert_tile_codes_equal(cuda_device, args, _placed(rng, args), shape)


def _fill_launches():
    return (fill_cuda.batch_moves.launches, fill_cuda.batch_last_rows.launches,
            fill_tile.gotoh_tile.launches)


def test_single_pair_align_on_gotoh_tile(cuda_device):
    """A pair that fill_tile.route sends to gotoh_tile: one gotoh_tile and
    one walk_block launch, equal to device='cpu'."""
    rng = np.random.default_rng(17)
    s1 = "".join(rng.choice(list("ACGT"), 1200))
    s2 = "".join(rng.choice(list("ACGT"), 1100))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fill_tile.route(1, 1200, 1100, True, sms)
    before = _fill_launches(), linear_tb.walk_block.launches
    got = find_global_alignment(seq_1=s1, seq_2=s2, device="cuda")
    after = _fill_launches(), linear_tb.walk_block.launches
    assert after == ((before[0][0], before[0][1], before[0][2] + 1),
                     before[1] + 1)
    want = find_global_alignment(seq_1=s1, seq_2=s2, device="cpu")
    assert got == want and str(got) == str(want)


def test_blocked_checkpoint_pass_is_one_launch(cuda_device):
    """3000 x 2500 in blocks: the checkpoint pass is one gotoh_tile launch,
    each replay one fill where fill_tile.route sends it; = device='cpu'."""
    rng = np.random.default_rng(18)
    s1 = "".join(rng.choice(list("ACGT"), 3000))
    s2 = "".join(rng.choice(list("ACGT"), 2500))
    scheme = resolve_scheme(s1, s2)
    budget = 2_000_000
    bounds = linear_tb.block_bounds(3000, 2500, block_moves_bytes=budget)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tiled = sum(fill_tile.route(1, i1 - i0, 2500, True, sms)
                for i0, i1 in zip(bounds, bounds[1:]))
    before = _fill_launches()
    got = GotohAligner(scheme, moves_budget_bytes=budget, device="cuda").align(
        s1, s2)
    after = _fill_launches()
    nblocks = len(bounds) - 1
    assert nblocks >= 4
    assert after == (before[0] + nblocks - tiled, before[1],
                     before[2] + 1 + tiled)
    want = GotohAligner(scheme, moves_budget_bytes=budget, device="cpu").align(
        s1, s2)
    assert got == want


@pytest.mark.parametrize("m,n", [(2048, 1900), (1025, 4000)])
def test_split_cost_on_gotoh_tile(cuda_device, m, n):
    """cost() from SPLIT_MIN_ROWS rows: the 2-pair last-rows fill where
    fill_tile.route sends it, equal to the plain split and the direct fill."""
    rng = np.random.default_rng(m + n)
    ta, tb, cost, gid, go, _, _ = _case(rng, "ACGT", [(m, n)])
    assert m >= SPLIT_MIN_ROWS
    want = fill_split.split_fill_cost(ta[0], tb[0], cost, gid, go)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tiled = fill_tile.route(2, m - m // 2, n, False, sms)
    before = _fill_launches()
    got = fill_split.split_fill_cost(
        ta[0].to(cuda_device), tb[0].to(cuda_device), cost.to(cuda_device), gid, go
    )
    after = _fill_launches()
    assert after == (before[0], before[1] + (not tiled), before[2] + tiled)
    direct, _ = fill_cuda.batch_moves(
        ta.to(cuda_device), tb.to(cuda_device), cost.to(cuda_device), gid, go,
        [m], [n], want_moves=False,
    )
    assert int(got) == int(want) == int(direct.min())


# -- a call's letters: tokenize_ragged and render_ragged ---------------------

PACKED_LETTERS = ["ACGT", "ARNDCQEGHILKMFPSTWYV", "ΩЖ字A", "ACGTΩЖ字"]


def _packed_call(rng, letters, shapes, with_render):
    """``pack_call`` of pairs of the given (m, n), align_pairs' buckets."""
    from globalign_tpu_torch.utils.tokenize import Alphabet

    pairs = [tuple("".join(rng.choice(list(letters), k)) for k in mn)
             for mn in shapes]
    buckets = {}
    for a, b in pairs:
        key = (bucket_length(max(len(a), 1)), bucket_length(max(len(b), 1)))
        buckets.setdefault(key, ([], []))
        buckets[key][0].append(a)
        buckets[key][1].append(b)
    spec = [(s1, s2, m, n) for (m, n), (s1, s2) in buckets.items()]
    return pairs, spec, packed.pack_call(Alphabet.from_sequences(letters), spec,
                                         with_render=with_render)


@pytest.mark.parametrize("letters", PACKED_LETTERS)
def test_tokenize_ragged_matches_plain(cuda_device, letters):
    """Every bucket row, one launch and one upload, = ``tokenize_plain``
    (tolerance 0): m and n of 1, rows at the 32-column bucket edges, ASCII
    bytes and code points."""
    rng = np.random.default_rng(len(letters))
    shapes = [(1, 1), (1, 32), (32, 1), (33, 64), (31, 65), (200, 7), (96, 96)]
    _, spec, call = _packed_call(rng, letters, shapes, False)
    want = _packed_call(np.random.default_rng(len(letters)), letters, shapes, False)[2]
    want.upload(torch.device("cpu"))
    want.tokenize()
    before = (packed.tokenize_ragged.launches, packed.upload.copies)
    call.upload(cuda_device)
    call.tokenize()
    torch.cuda.synchronize()
    assert (packed.tokenize_ragged.launches - before[0],
            packed.upload.copies - before[1]) == (1, 1)
    for k in range(len(spec)):
        for got, ref in zip(call.bucket(k), want.bucket(k)):
            assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("letters", ["ACGT", "ΩЖ字A"])
@pytest.mark.parametrize("shapes", [
    [(5, 9, 3), (1, 7, 6), (12, 12, 0), (3, 40, 20)],  # row-0 exits
    [(1, 1, 0), (1, 0, 0), (0, 1, 0), (0, 1, 1)],  # tapes of one op
    [(1, 33, 0), (33, 1, 0), (1, 1, 1), (2, 1, 0)],  # m or n of 1
    [(0, 7, 0), (0, 7, 7), (9, 0, 0), (4, 4, 4)],  # all-gap lines
    [(300, 290, 0), (64, 100, 37), (1000, 999, 2)],  # many warp chunks
])
def test_render_ragged_matches_plain(cuda_device, letters, shapes):
    """A segment's lines, one launch, = ``render_plain`` (tolerance 0),
    ends included; a second launch after a base continues the buffer."""
    rng = np.random.default_rng(sum(m + n + e for m, n, e in shapes))
    _, _, call = _packed_call(rng, letters, [(m, n) for m, n, _ in shapes], True)
    tapes = []
    for m, n, e in shapes:
        diag = int(rng.integers(0, min(m, n - e) + 1))
        ops = ([linear_tb.OP_DIAG] * diag + [linear_tb.OP_UP] * (m - diag)
               + [linear_tb.OP_LEFT] * (n - e - diag))
        tapes.append(np.array(rng.permutation(ops), np.uint8))
    ops = np.zeros((len(tapes), max(len(t) for t in tapes) + 5), np.uint8)
    for k, t in enumerate(tapes):
        ops[k, : len(t)] = t
    # pack_call orders a bucket's pairs together: the tapes follow its order
    args = (torch.from_numpy(ops), torch.tensor([len(t) for t in tapes], dtype=torch.int32),
            torch.tensor([e for *_, e in shapes], dtype=torch.int32))
    order = _bucket_order([(m, n) for m, n, _ in shapes])
    args = tuple(a[order].contiguous() for a in args)
    call.upload(torch.device("cpu"))
    want_lines = call.lines().fill_(0)
    want = packed.render_ragged(*args, call.letters, call.render_desc, want_lines)
    half = len(shapes) // 2
    want_2 = packed.render_ragged(*(a[half:] for a in args), call.letters,
                                  call.render_desc[half:], want_lines, want[half - 1 : half])
    letters_cpu, desc_cpu = call.letters, call.render_desc
    call.upload(cuda_device)
    got_lines = call.lines().fill_(0)
    before = packed.render_ragged.launches
    got = packed.render_ragged(*(a.to(cuda_device) for a in args), call.letters,
                               call.render_desc, got_lines)
    got_2 = packed.render_ragged(*(a[half:].to(cuda_device) for a in args),
                                 call.letters, call.render_desc[half:], got_lines,
                                 got[half - 1 : half])
    torch.cuda.synchronize()
    assert packed.render_ragged.launches - before == 2
    assert torch.equal(letters_cpu, call.letters.cpu())
    assert torch.equal(desc_cpu, call.render_desc.cpu())
    assert torch.equal(got.cpu(), want) and torch.equal(got_2.cpu(), want_2)
    assert torch.equal(got_lines.cpu(), want_lines)


def _bucket_order(shapes):
    """The pack order of pairs of these (m, n): by bucket of first
    appearance, then input order."""
    keys = {}
    for k, (m, n) in enumerate(shapes):
        keys.setdefault((bucket_length(max(m, 1)), bucket_length(max(n, 1))),
                        []).append(k)
    return [k for ks in keys.values() for k in ks]


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("name", ["dna", "unicode", "segments"])
def test_align_pairs_one_upload_one_tokenize_one_fetch(cuda_device, tmp_path,
                                                      monkeypatch, name,
                                                      with_traceback):
    """On the card a call makes one letters upload, one ``tokenize_ragged``
    launch, one ``render_ragged`` launch a traceback segment and one
    fetch; its results are byte-identical to ``device="cpu"`` (a non-ASCII
    matrix; several segments under a lowered budget)."""
    rng = np.random.default_rng(19 + with_traceback)
    kw, letters = {}, "ACGT"
    if name == "unicode":
        mtx = tmp_path / "unicode.mtx"
        mtx.write_text("Ω Ж 字 A -\nΩ 4 -2 -3 -1 -3\nЖ -2 5 -1 -3 -3\n"
                       "字 -3 -1 4 -2 -3\nA -1 -3 -2 5 -3\n- -3 -3 -3 -3 4\n",
                       encoding="utf-8")
        kw, letters = dict(scoring_mat_path=mtx), "ΩЖ字A"
    pairs = [tuple("".join(rng.choice(list(letters), int(rng.integers(1, 200))))
                   for _ in range(2)) for _ in range(40)]
    pairs += [(letters[0], letters[1] * 50), (letters[2] * 30, letters[3])]
    segments = 1
    if name == "segments":
        monkeypatch.setattr(batch_mod, "_segment_budget", lambda device: (
            fill_cuda.ragged_bytes(192, 192) * 3))
    counters = (packed.upload, batch_mod._to_host)
    kernels = (packed.tokenize_ragged, packed.render_ragged, linear_tb.walk_ragged)
    before = [c.copies for c in counters] + [k.launches for k in kernels]
    got = align_pairs(pairs, with_traceback=with_traceback, **kw)
    after = [c.copies for c in counters] + [k.launches for k in kernels]
    counts = [a - b for a, b in zip(after, before)]
    if with_traceback:
        segments = counts[4]
        assert segments >= (3 if name == "segments" else 1)
    assert counts == [1, 1, 1, segments if with_traceback else 0,
                      segments if with_traceback else 0]
    want = align_pairs(pairs, with_traceback=with_traceback, device="cpu", **kw)
    assert got == want


@pytest.mark.parametrize("with_traceback", [False, True])
def test_align_pairs_fill_spans_on_the_card(cuda_device, with_traceback):
    """A call holding a pair past 1024 columns opens ``globalign.fill.batch``
    and ``globalign.fill.wide`` (and with traceback ``globalign.fill.walk``)
    inside ``globalign.fill``, and ``phase_seconds`` gets none of them."""
    from torch.profiler import ProfilerActivity, profile


    rng = np.random.default_rng(23 + with_traceback)
    pairs = [tuple("".join(rng.choice(list("ACGT"), int(rng.integers(20, 300))))
                   for _ in range(2)) for _ in range(24)]
    pairs.append(("".join(rng.choice(list("ACGT"), 400)),
                  "".join(rng.choice(list("ACGT"), 1100))))
    phases = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = align_pairs(pairs, with_traceback=with_traceback,
                          phase_seconds=phases)
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("globalign.fill")]
    fills = [(s, e) for name, s, e in ranges if name == "globalign.fill"]
    subs = {"globalign.fill.batch", "globalign.fill.wide"}
    if with_traceback:
        subs.add("globalign.fill.walk")
    assert {name for name, _, _ in ranges} == subs | {"globalign.fill"}
    for name, s, e in ranges:
        assert any(lo <= s and e <= hi for lo, hi in fills), name
    assert not any(key.startswith("fill.") for key in phases)
    assert got == align_pairs(pairs, with_traceback=with_traceback, device="cpu")


# -- the kernels at the main paths' sizes ------------------------------------
#
# The tests above hold each kernel against its plain version at its edges;
# these add the sizes its callers reach (pairs to 8000^2, replay blocks of
# 20 000 columns, the blocked pairs' checkpoint rows, buffers past byte
# 2^31), the same schemes, tolerance 0.  ``ptxas -v`` of every source
# guards against spills, which cost a kernel its speed and no test its
# result.

# The gotoh_fill instances that spill, and the most bytes (spill stores and
# loads) each may: W = 32 cost-only, the table in shared memory or not;
# W = 16 with codes, the table in shared memory; W = 16 ragged, the table in
# global memory.  The genome cell's instance (W = 16 ragged, the table in
# shared memory) does not spill.
GOTOH_FILL_SPILLS = {"Li32ELb0ELb0ELb0E": 212, "Li32ELb0ELb1ELb0E": 220,
                     "Li16ELb1ELb1ELb0E": 24, "Li16ELb1ELb0ELb1E": 56}
PTXAS_INSTANCES = {  # the template instances of each source
    "gotoh_batch": 2 * len(fill_batch.WIDTHS),  # W x last rows or not
    "gotoh_batch_moves": len(fill_batch.WIDTHS),
    "gotoh_fill": 20,  # W 4/8/16 x codes x table x ragged (codes), W 32 x table
    "gotoh_tile": 4 * len(fill_tile.SHAPES),  # (H, W) x codes x table
    "render": 2,  # bytes, code points
    "tokenize": 2,
    "walk_block": 2,  # a block, ragged
    "wave_split": 1,
}


@pytest.fixture(scope="module", autouse=True)
def _ptxas_jobs(request, tmp_path_factory):
    """``ptxas -v`` of every source for sm_90a, started with the module
    where a card, ``nvcc`` and a selected ptxas test are present, so that
    it compiles beside the kernels' build: the processes by source."""
    from globalign_tpu_torch.utils import cuda_build

    jobs = {}
    if torch.cuda.is_available() and any(
            "ptxas" in item.name for item in request.session.items):
        try:
            nvcc = cuda_build._nvcc()
        except RuntimeError:
            nvcc = None
        out = tmp_path_factory.mktemp("ptxas")
        # The build's own flags, less those of a shared library.
        flags = [f for f in cuda_build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        jobs = {
            stem: subprocess.Popen(
                [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
                 str(out / f"{stem}.cubin"),
                 str(cuda_build.CSRC_DIR / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for stem in PTXAS_INSTANCES
        } if nvcc else {}
    yield jobs
    for proc in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ptxas_reports(_ptxas_jobs):
    """By source, (template arguments, registers, spill bytes) an
    instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if not _ptxas_jobs:
        pytest.skip("nvcc was not found")
    reports = {}
    for stem, proc in _ptxas_jobs.items():
        text, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, text
        reports[stem] = [
            (re.search(r"kernel(?:I(\w+?)EEv)?", block).group(1),
             int(re.search(r"Used (\d+) registers", block).group(1)),
             sum(int(x) for x in re.search(
                 r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                 block).groups()))
            for block in text.split("Compiling entry function")[1:]
        ]
    return reports


@pytest.mark.parametrize("stem", sorted(PTXAS_INSTANCES))
def test_ptxas_reports_no_spills(ptxas_reports, stem):
    """Every instance of every kernel compiles for sm_90a, without a spill
    but gotoh_fill's known ones (no more bytes than they spill today)."""
    report = ptxas_reports[stem]
    assert len(report) == PTXAS_INSTANCES[stem], report
    known = GOTOH_FILL_SPILLS if stem == "gotoh_fill" else {}
    assert not [row for row in report if row[2] > known.get(row[0], 0)], report


def _seq(rng, letters, k):
    return "".join(rng.choice(list(letters), k))


def _relative(rng, seq, letters, identity=0.85):
    """A relative of ``seq`` as long as it: substitutions and short indels."""
    out = []
    p_sub, p_indel = (1 - identity) * 0.6, (1 - identity) * 0.2
    for ch in seq:
        r = rng.random()
        if r < p_sub:
            out.append(rng.choice([c for c in letters if c != ch]))
        elif r < p_sub + p_indel:
            continue
        elif r < p_sub + 2 * p_indel:
            out.append(ch + _seq(rng, letters, int(rng.integers(1, 4))))
        else:
            out.append(ch)
    out = "".join(out)[: len(seq)]
    return out + _seq(rng, letters, len(seq) - len(out))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _no_tile(patch):
    """Every non-strip fill on gotoh_fill from here (``fill_tile.route``
    says no), to hold gotoh_fill where the route takes gotoh_tile."""
    patch.setattr(fill_tile, "route", lambda *args: False)


@pytest.mark.parametrize("letters,kw,shapes", [
    ("ACGT", {}, [(1, 500)]), ("ACGT", {}, [(500, 1)]),
    ("ACGT", {}, [(37, 129)]), ("ACGT", {}, [(1000, 1000)]),
    (PROTEIN, BLOSUM, [(700, 900)]), ("ACGT", ODD, [(300, 417)]),
    (WIDE, WIDE_KW, [(256, 300)]), ("ACGT", {}, [(50, 70), (64, 3), (9, 128)]),
    ("ACGT", {}, [(4096, 4096)]), ("ACGT", {}, [(8000, 8000)]),
])
def test_both_fills_match_plain_at_main_path_sizes(cuda_device, monkeypatch,
                                                   letters, kw, shapes):
    """gotoh_fill (the route set aside) and gotoh_tile at its plan's shape,
    with codes and cost only: final3 and every code == the row scan."""
    args = _case(np.random.default_rng(sum(m + n for m, n in shapes)),
                 letters, shapes, **kw)
    want3, want_mv = fill_cuda.batch_moves(*args)
    with monkeypatch.context() as patch:
        _no_tile(patch)
        got3, got_mv = fill_cuda.batch_moves(*_on(cuda_device, args))
        cost3, none = fill_cuda.batch_moves(*_on(cuda_device, args),
                                            want_moves=False)
    assert none is None
    t3, t_mv, _ = fill_tile.gotoh_tile(*_on(cuda_device, args))
    t3c, _, _ = fill_tile.gotoh_tile(*_on(cuda_device, args), want_moves=False)
    for got in (got3, cost3, t3, t3c):
        assert torch.equal(got.cpu(), want3)
    assert torch.equal(got_mv.cpu(), want_mv) and torch.equal(t_mv.cpu(), want_mv)


@pytest.mark.parametrize("letters,kw,shapes,cuts", [
    ("ACGT", {}, [(4096, 4096)], [2048]),
    # the main path's widths: a short block below row 1000 of a 10 000-,
    # a 20 000- and a 9000-column pair, a ragged batch of 12 500-20 000
    ("ACGT", {}, [(1300, 10_000)], [1000]),
    ("ACGT", {}, [(1300, 20_000)], [1000]),
    (PROTEIN, BLOSUM, [(1300, 9000)], [1000]),
    ("ACGT", {}, [(300, 20_000), (1256, 19_000), (70, 12_500)], [44, 1000, 6]),
    ("ACGT", {}, [(1000, 1000)], [999]),  # a one-row block
    ("ACGT", {}, [(1, 500)], [0]),
    (PROTEIN, BLOSUM, [(700, 900)], [301]),
    ("ACGT", ODD, [(300, 417)], [150]),
    (WIDE, WIDE_KW, [(256, 300)], [100]),
    ("ACGT", {}, [(50, 70), (64, 3), (9, 128)], [20, 63, 0]),
    # replay blocks of 3355 rows (the 20 000^2 blocked align's)
    ("ACGT", {}, [(4355, 10_000)], [1000]),
    ("ACGT", {}, [(4355, 20_000)], [1000]),
])
def test_injected_fills_on_both_kernels_at_main_path_sizes(
        cuda_device, monkeypatch, letters, kw, shapes, cuts):
    """Blocks seeded from the real row at each cut, on gotoh_fill (the
    route set aside) and on gotoh_tile: final3, codes and the last row ==
    the row scan; the whole pair's last row on both == the block's; and
    the walk over a single block's codes, from its corner and from inside
    it, == the plain walk."""
    rng = np.random.default_rng(sum(n for _, n in shapes) + cuts[0])
    args = _case(rng, letters, shapes, **kw)
    blk, top, c0 = _checkpointed(args, cuts)
    inj = dict(row0=top, col0y_top=c0)
    dev_inj = {k: v.to(cuda_device) for k, v in inj.items()}
    rows = [[r] for r in blk[5]]
    want3, want_mv, want_rows = fill_tile.gotoh_tile(*blk, rows=rows, **inj)
    want_last = want_rows[:, 0]
    with monkeypatch.context() as patch:
        _no_tile(patch)
        got3, got_mv = fill_cuda.batch_moves(*_on(cuda_device, blk), **dev_inj)
        got_last = fill_cuda.batch_last_rows(*_on(cuda_device, blk), **dev_inj)
        got_whole = fill_cuda.batch_last_rows(*_on(cuda_device, args))
    t3, t_mv, t_rows = fill_tile.gotoh_tile(*_on(cuda_device, blk), rows=rows,
                                            **dev_inj)
    _, _, t_whole = fill_tile.gotoh_tile(*_on(cuda_device, args),
                                         want_moves=False,
                                         rows=[[m] for m in args[5]])
    for got, want in ((got3, want3), (got_mv, want_mv), (got_last, want_last),
                      (got_whole, want_last), (t3, want3), (t_mv, want_mv),
                      (t_rows, want_rows), (t_whole[:, 0], want_last)):
        assert torch.equal(got.cpu(), want)
    if len(shapes) == 1 and shapes[0][1] >= 4096:
        k_rows, n_cols = blk[5][0], shapes[0][1]
        level = got3.argmin(-1).to(torch.int32)
        for i_entry, j_entry in (([k_rows], [n_cols]), ([k_rows // 3], [17])):
            j_dev = torch.tensor(j_entry, dtype=torch.int32, device=cuda_device)
            want = linear_tb.walk_block(got_mv.cpu(), i_entry, j_dev.cpu(),
                                        level.cpu())
            got = linear_tb.walk_block(got_mv, i_entry, j_dev, level)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


def test_checkpoint_rows_of_a_blocked_pair_at_every_tile_shape(cuda_device):
    """The blocked align's checkpoint rows of a 20 000^2 DNA pair, one
    launch at every (H, W), == the row scan block by block."""
    rng = np.random.default_rng(20_000)
    s1 = _seq(rng, "ACGT", 20_000)
    args = _args(resolve_scheme("ACGT", "ACGT"), [(s1, _relative(rng, s1, "ACGT"))])
    rows = linear_tb.block_bounds(
        args[5][0], args[6][0], block_moves_bytes=DEFAULT_MOVES_BUDGET_BYTES)[1:]
    want = fill_tile.checkpoint_rows(args[0][0], args[1][0], *args[2:5], rows)
    for shape in fill_tile.SHAPES:
        before = fill_tile.gotoh_tile.launches
        _, _, got = fill_tile.gotoh_tile(*_on(cuda_device, args),
                                         want_moves=False, rows=[rows],
                                         shape=shape)
        assert fill_tile.gotoh_tile.launches == before + 1
        assert torch.equal(got[0].cpu(), want), shape


def _ragged_args(buckets):
    """``batch_moves_ragged``'s arguments from ``_case`` buckets."""
    return ([b[0] for b in buckets], [b[1] for b in buckets], *buckets[0][2:5],
            [b[5] for b in buckets], [b[6] for b in buckets])


def _ragged_on(dev, args):
    return ([t.to(dev) for t in args[0]], [t.to(dev) for t in args[1]],
            args[2].to(dev), *args[3:])


def _assert_ragged_equal(got, want):
    """final3 and every byte of each pair's rows equal."""
    assert torch.equal(got.final3.cpu(), want.final3)
    for row in want.layout.tolist():
        lo, hi = row[4], row[4] + (row[2] + 1) * row[5]
        assert torch.equal(got.codes[lo:hi].cpu(), want.codes[lo:hi]), row[2:4]


@pytest.mark.parametrize("letters,kw,shapes", [
    ("ACGT", {}, [[(40, 33_000), (3, 5000)], [(1, 1), (0, 7), (9, 0), (1, 300)],
                  [(200, 300), (300, 1), (250, 290)], [(64, 2100), (1000, 1000)]]),
    (PROTEIN, BLOSUM, [[(700, 900), (1, 1)], [(30, 4096), (90, 33)]]),
    (WIDE, WIDE_KW, [[(256, 300), (1, 2)], [(5, 1030)]]),
])
def test_ragged_fill_and_walk_at_main_path_sizes(cuda_device, letters, kw,
                                                 shapes):
    """A call mixing both routes (gotoh_batch_moves up to 1024 columns, a
    gotoh_fill ragged launch a launch class past them) and its one walk,
    under DNA, BLOSUM62 and the 60-letter alphabet: final3, codes, tapes,
    counts and exit columns == the plain versions."""
    rng = np.random.default_rng(len(shapes) + len(letters))
    args = _ragged_args([_case(rng, letters, sh, **kw) for sh in shapes])
    want = fill_cuda.batch_moves_ragged(*args)
    warp, classes, _ = fill_cuda.ragged_routes(
        [m for ms in args[5] for m in ms], [n for ns in args[6] for n in ns],
        args[2].shape[0], _sms(cuda_device))
    counters = (fill_batch.batch_moves_warp, fill_cuda.batch_moves_ragged,
                linear_tb.walk_ragged)
    before = [fn.launches for fn in counters]
    got = fill_cuda.batch_moves_ragged(*_ragged_on(cuda_device, args))
    got_walk = linear_tb.walk_ragged(got)
    torch.cuda.synchronize()
    assert warp and classes
    assert [fn.launches - k for fn, k in zip(counters, before)] == [
        len(warp), len(classes), 1]
    _assert_ragged_equal(got, want)
    for g, w in zip(got_walk, linear_tb.walk_ragged(want)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("codes", ["filled", "random"])
def test_walk_ragged_at_its_tile_edges(cuda_device, codes):
    """walk_ragged over pairs packed tight: 3 x 40 000, 40 000 x 3, m or n of
    0 and 1, and n + 1 at every residue mod 16, over their fill's codes
    (the fill == the plain version) or random codes in their place: tapes,
    counts and exit columns == the plain walk over the same codes."""
    rng = np.random.default_rng(11)
    shapes = ([(3, 40_000), (40_000, 3), (0, 5), (5, 0), (1, 1), (0, 0), (1, 0),
               (0, 1), (1, 7), (7, 1)] + [(45, 15 + k) for k in range(16)])
    args = _ragged_args([_case(rng, "ACGT", [sh]) for sh in shapes])
    got = fill_cuda.batch_moves_ragged(*_ragged_on(cuda_device, args))
    if codes == "filled":
        _assert_ragged_equal(got, fill_cuda.batch_moves_ragged(*args))
    else:
        lv = rng.integers(0, 3, (got.codes.numel(), 3))
        noise = (lv[:, 0] | lv[:, 1] << 2 | lv[:, 2] << 4).astype(np.uint8)
        got = got._replace(codes=torch.from_numpy(noise).to(cuda_device))
    host = fill_cuda.RaggedMoves(got.final3.cpu(), got.codes.cpu(),
                                 got.desc.cpu(), got.layout)
    before = linear_tb.walk_ragged.launches
    walk = linear_tb.walk_ragged(got)
    torch.cuda.synchronize()
    assert linear_tb.walk_ragged.launches == before + 1
    for g, w in zip(walk, linear_tb.walk_ragged(host)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("letters,kw,m,n", [
    ("ACGT", {}, 2, 0), ("ACGT", {}, 1, 300), ("ACGT", {}, 2000, 1999),
    (PROTEIN, BLOSUM, 701, 900), ("ACGT", {}, 300, 10_000),
    ("ACGT", {}, 3, 20_000), (PROTEIN, BLOSUM, 301, 9000),
])
def test_split_cost_at_main_path_sizes(cuda_device, letters, kw, m, n):
    ta, tb, cost, gid, go, _, _ = _case(np.random.default_rng(m + n), letters,
                                        [(m, n)], **kw)
    want = fill_split.split_fill_cost(ta[0], tb[0], cost, gid, go)
    got = fill_split.split_fill_cost(ta[0].to(cuda_device), tb[0].to(cuda_device),
                                     cost.to(cuda_device), gid, go)
    assert int(got) == int(want)


@pytest.mark.parametrize("n_cols", [1, 31, 33, 255, 1023, 1024, 1025])
@pytest.mark.parametrize("letters,kw", [
    ("ACGT", {}), (PROTEIN, BLOSUM), ("ACGT", ODD), (WIDE, WIDE_KW),
])
def test_gotoh_batch_three_buckets_across_the_cap(cuda_device, letters, kw,
                                                  n_cols):
    """A ragged call of three buckets: one of ``n_cols`` columns (m_true 0,
    1, 7 and M, partial and zero widths; past the 1024-column cap at 1025),
    one of every width class and one of 1023 / 1024 columns: final3 and
    the last rows == plain, one gotoh_batch launch a width class a mode,
    and a bucket past the cap on the wide route's gotoh_tile or on
    gotoh_fill, as ``fill_tile.route_buckets`` says."""
    rows = 300 if n_cols <= 255 else 200
    shapes = [
        [(rows, n_cols), (0, n_cols), (1, n_cols), (rows, max(0, n_cols - 7)),
         (rows // 2, n_cols // 3), (rows, 0), (7, n_cols), (rows, 1)],
        [(40, 20), (1, 100), (33, 129), (70, 256), (7, 257), (90, 511),
         (0, 700), (64, 1000)],
        [(50, 1023), (1, 1024), (7, 1024)],
    ]
    rng = np.random.default_rng(n_cols + len(letters))
    buckets = [_case(rng, letters, sh, **kw) for sh in shapes]
    args = _ragged_args(buckets)
    classes = {fill_batch.width_class(n) for b in buckets for n in b[6]
               if b[1].shape[1] - 1 <= fill_batch.MAX_COLUMNS}
    wide = [(b[5], b[6]) for b in buckets
            if b[1].shape[1] - 1 > fill_batch.MAX_COLUMNS]
    tiled = len(fill_tile.route_buckets(wide, _sms(cuda_device)))
    want3 = fill_batch.batch_final3_ragged(*args)
    want_last = fill_batch.batch_final3_ragged(*args, last_rows=True)

    def counts():
        return (fill_batch.batch_final3.launches, fill_cuda.batch_moves.launches,
                fill_cuda.batch_last_rows.launches,
                fill_batch.batch_final3_ragged.wide_launches)

    before = counts()
    got3 = fill_batch.batch_final3_ragged(*_ragged_on(cuda_device, args))
    got_last = fill_batch.batch_final3_ragged(*_ragged_on(cuda_device, args),
                                              last_rows=True)
    torch.cuda.synchronize()
    untiled = len(wide) - tiled
    assert [a - b for a, b in zip(counts(), before)] == [
        2 * len(classes), untiled, untiled, 2 * bool(tiled)]
    assert torch.equal(got3.cpu(), want3)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got_last, want_last))


@pytest.mark.parametrize("lone", [True, False])
def test_gotoh_batch_one_pair_and_two_an_sm(cuda_device, lone):
    """One width class at a batch of 1 (a lone warp on the card, a 1024^2
    pair) and of 2 x SMs (64 x 1000 pairs: the plain fill runs pair by
    pair): one launch, final3 == plain."""
    shapes = [(1024, 1024)] if lone else [(64, 1000)] * (2 * _sms(cuda_device))
    args = _case(np.random.default_rng(len(shapes)), "ACGT", shapes)
    want = fill_batch.batch_final3(*args)
    before = fill_batch.batch_final3.launches
    got = fill_batch.batch_final3(*_on(cuda_device, args))
    torch.cuda.synchronize()
    assert fill_batch.batch_final3.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("batch,lo,hi", [(1, 0, 32), (33, 0, 32), (132, 0, 32),
                                         (5, 992, 1024)])
@pytest.mark.parametrize("letters,kw", [
    ("ACGT", {}), (PROTEIN, BLOSUM), (WIDE, WIDE_KW),
])
def test_batch_final3_dual_at_main_path_shapes(cuda_device, batch, lo, hi,
                                               letters, kw):
    """Two sets of ``batch`` pairs, rows lo..hi (short rows for many pairs,
    a 1024 bucket's top rows for a few), 1 to 5000 columns: one launch a
    width class (one gotoh_fill launch past the cap), == plain."""
    rng = np.random.default_rng(batch + hi)
    # The plain fill runs pair by pair: 5000 columns at a 1024 bucket's top
    # rows or for 2 x 132 pairs took 4-5 s a scheme, and past the cap a
    # dual call is one gotoh_fill launch at any N.
    for n_cols in (1, 64, fill_batch.MAX_COLUMNS, 1025) + (
            (5000,) * (batch <= 33 and hi <= 32)):
        shapes = [(int(rng.integers(lo, hi + 1)), int(rng.integers(0, n_cols + 1)))
                  for _ in range(2 * batch)]
        shapes[0] = (hi, n_cols)
        ta, tb, cost, gid, go, mt, nt = _case(rng, letters, shapes, **kw)
        args = (ta.reshape(2, batch, -1), tb.reshape(2, batch, -1), cost, gid,
                go, np.reshape(mt, (2, batch)), np.reshape(nt, (2, batch)))
        want = fill_batch.batch_final3_dual(*args)

        def counts():
            return (fill_batch.batch_final3.launches
                    + fill_cuda.batch_moves.launches
                    + fill_tile.gotoh_tile.launches)

        before = counts()
        got = fill_batch.batch_final3_dual(
            args[0].to(cuda_device), args[1].to(cuda_device),
            cost.to(cuda_device), *args[3:])
        torch.cuda.synchronize()
        design = 1 if n_cols > fill_batch.MAX_COLUMNS else len(
            {fill_batch.width_class(n) for n in nt})
        assert counts() == before + design
        assert torch.equal(got.cpu(), want), n_cols


# -- the main paths, launch by launch ----------------------------------------
#
# Each main path at its users' sizes on the card, against device="cpu", the
# single-pair path or the route it replaced, with every launch and copy it
# makes counted (``launches``) and held to its design: the launch plan the
# host rules give.  Every gotoh_fill launch is also tallied where it is
# made (``fill_cuda._launch``) and held to its wrappers' counts.

GOLDENS = [  # tests/test_conformance.py:19-31: seq_1, seq_2, the four
    # scores, then the score and cost
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
SCHEMES = {"dna": ("ACGT", {}), "blosum62": (PROTEIN, BLOSUM)}


def _counts() -> dict:
    """Every launch and copy counter of the port, by name."""
    wrappers = {
        "batch_moves": fill_cuda.batch_moves,
        "batch_last_rows": fill_cuda.batch_last_rows,
        "strip_fill_block": fill_cuda.strip_fill_block,
        "batch_moves_ragged": fill_cuda.batch_moves_ragged,
        "batch_final3": fill_batch.batch_final3,
        "batch_moves_warp": fill_batch.batch_moves_warp,
        "gotoh_tile": fill_tile.gotoh_tile,
        "wave_frontiers": fill_wave.wave_frontiers,
        "walk_block": linear_tb.walk_block,
        "walk_ragged": linear_tb.walk_ragged,
        "tokenize_ragged": packed.tokenize_ragged,
        "render_ragged": packed.render_ragged,
    }
    out = {name: fn.launches for name, fn in wrappers.items()}
    out["letters_upload"] = packed.upload.copies
    out["fetch"] = batch_mod._to_host.copies
    out["wide_launches"] = fill_batch.batch_final3_ragged.wide_launches
    out["wide_pairs"] = fill_batch.batch_final3_ragged.wide_pairs
    out["tile_launches"] = fill_cuda.batch_moves_ragged.tile_launches
    out["tile_pairs"] = fill_cuda.batch_moves_ragged.tile_pairs
    return out


@pytest.fixture
def launches(cuda_device, monkeypatch):
    """``launches()``: the counts of ``_counts`` that moved since the last
    call, after a synchronise.  Each call also holds the gotoh_fill
    launches made meanwhile (every call of ``fill_cuda._launch``) to the
    counts of its three wrappers."""
    made = []
    real = fill_cuda._launch

    def tallied(*args, **kw):
        made.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fill_cuda, "_launch", tallied)
    last = [_counts()]

    def moved():
        torch.cuda.synchronize()
        now = _counts()
        out = {k: now[k] - last[0][k] for k in now if now[k] != last[0][k]}
        assert len(made) == sum(out.get(k, 0) for k in (
            "batch_moves", "batch_last_rows", "strip_fill_block")), out
        made.clear()
        last[0] = now
        return out

    return moved


def _design(dev, *fills, **counts) -> dict:
    """A launch design: ``counts`` plus one launch a non-strip fill
    ``(batch, m, n, with codes, its gotoh_fill wrapper)``, counted on
    gotoh_tile where ``fill_tile.route`` sends it; names of no launch left
    out."""
    out = collections.Counter(counts)
    for batch, m, n, moves, wrapper in fills:
        out["gotoh_tile" if fill_tile.route(batch, m, n, moves, _sms(dev))
            else wrapper] += 1
    return {k: v for k, v in out.items() if v}


def _cost_fill(m, n):
    """cost()'s one fill: the split's 2-pair last rows from SPLIT_MIN_ROWS
    rows of seq_1, the direct cost-only fill below."""
    if m >= SPLIT_MIN_ROWS:
        return (2, m - m // 2, n, False, "batch_last_rows")
    return (1, m, n, False, "batch_moves")


def _blocked_fills(m, n, budget=DEFAULT_MOVES_BUDGET_BYTES):
    """The replay fills of a blocked align: one a block, with codes."""
    bounds = linear_tb.block_bounds(m, n, block_moves_bytes=budget)
    return [(1, i1 - i0, n, True, "batch_moves")
            for i0, i1 in zip(bounds, bounds[1:])]


def _fields(r):
    return (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)


@functools.cache
def _chunk(letters: str, count: int = 1024, lo: int = 819, hi: int = 1024):
    """The runner's default chunk (seeded): ``count`` pairs, each length
    drawn from [lo, hi] on its own, seq_2 a relative of seq_1 cut or
    extended to its length."""
    rng = np.random.default_rng(count + lo + len(letters))
    pairs = []
    for _ in range(count):
        m, n = (int(x) for x in rng.integers(lo, hi + 1, 2))
        s1 = _seq(rng, letters, m)
        s2 = _relative(rng, s1, letters) + _seq(rng, letters, max(0, n - m))
        pairs.append((s1, s2[:n]))
    return tuple(pairs)


@functools.cache
def _long_pair(size: int, letters: str):
    rng = np.random.default_rng(size + len(letters))
    s1 = _seq(rng, letters, size)
    return s1, _relative(rng, s1, letters)


def _unicode_kw(tmp_path):
    mtx = tmp_path / "unicode.mtx"
    mtx.write_text(UNICODE_MTX, encoding="utf-8")
    return dict(scoring_mat_path=mtx)


def _single_runs(name, tmp_path):
    """(find_global_alignment's arguments, the golden (score, cost) or
    None) a pair."""
    if name == "goldens":
        return [(dict(seq_1="ACGT", seq_2="AGT"), (0, 7))] + [
            (dict(seq_1=a, seq_2=b, match_score=ma, mismatch_score=mi,
                  gap_open_score=go, gap_extension_score=ge), (score, cost))
            for a, b, ma, mi, go, ge, score, cost in GOLDENS]
    rng = np.random.default_rng(len(name))
    if name == "non-ASCII":
        kw = _unicode_kw(tmp_path)
        return [(dict(seq_1=_seq(rng, "ΩЖ字A", m), seq_2=_seq(rng, "ΩЖ字A", n),
                      **kw), None)
                for m, n in ((300, 280), (1, 9), (700, 650), (64, 1), (90, 95))]
    size, letters, kw = {"4096^2 DNA": (4096, "ACGT", {}),
                         "8000^2 DNA": (8000, "ACGT", {}),
                         "1500^2 BLOSUM62": (1500, PROTEIN, BLOSUM)}[name]
    s1 = _seq(rng, letters, size)
    return [(dict(seq_1=s1, seq_2=_relative(rng, s1, letters), **kw), None)]


@pytest.mark.parametrize("name", ["goldens", "4096^2 DNA", "8000^2 DNA",
                                  "1500^2 BLOSUM62", "non-ASCII"])
def test_single_pair_main_path(cuda_device, launches, monkeypatch, tmp_path,
                               name):
    """``find_global_alignment`` on the card == device="cpu" (strings,
    cost, score, report; the goldens' score and cost), one fill (routed)
    and one walk a pair; ``cost()`` one launch, == the direct fill == the
    alignment's cost.  At 8000^2 and 1500^2 BLOSUM62 the card's walk ==
    the host walk (``traceback_moves``) over the fetched codes, and the
    align == the same align on gotoh_fill.  Under the non-ASCII matrix,
    ``align_pairs`` in both modes == device="cpu" too."""
    from globalign_tpu_torch.ops.traceback import traceback_moves

    runs = _single_runs(name, tmp_path)
    want = [find_global_alignment(**kw, device="cpu") for kw, _ in runs]
    launches()
    got = [find_global_alignment(**kw, device="cuda") for kw, _ in runs]
    assert launches() == _design(
        cuda_device, *[(1, len(kw["seq_1"]), len(kw["seq_2"]), True,
                        "batch_moves") for kw, _ in runs],
        walk_block=len(runs))
    for (kw, golden), r, w in zip(runs, got, want):
        assert r == w and str(r) == str(w)
        if golden is not None:
            assert (r.score, r.cost) == golden
        s1, s2 = kw["seq_1"], kw["seq_2"]
        aligner = GotohAligner(validate_and_transform_args(**kw).scheme,
                               device="cuda")
        launches()
        cost = aligner.cost(s1, s2)
        assert launches() == _design(cuda_device, _cost_fill(len(s1), len(s2)))
        direct, _ = aligner._batch_fill(s1, s2, want_moves=False)
        assert cost == int(direct.min()) == r.cost
        if name in ("8000^2 DNA", "1500^2 BLOSUM62"):
            final3, moves = aligner._batch_fill(s1, s2, want_moves=True)
            assert (r.seq_1_aligned, r.middle_part, r.seq_2_aligned,
                    r.cost) == tuple(traceback_moves(
                        moves[0].cpu().numpy(), s1, s2, final3[0].cpu().numpy()))
            with monkeypatch.context() as patch:
                _no_tile(patch)
                on_fill = find_global_alignment(**kw, device="cuda")
            assert on_fill == r and str(on_fill) == str(r)
    if name == "non-ASCII":
        pairs = [(kw["seq_1"], kw["seq_2"]) for kw, _ in runs]
        mtx = runs[0][0]["scoring_mat_path"]
        for with_traceback in (False, True):
            assert align_pairs(pairs, scoring_mat_path=mtx,
                               with_traceback=with_traceback) == align_pairs(
                pairs, scoring_mat_path=mtx, with_traceback=with_traceback,
                device="cpu")


@pytest.mark.parametrize("size,letters,kw", [
    (10_000, "ACGT", {}), (20_000, "ACGT", {}), (9000, PROTEIN, BLOSUM),
])
def test_blocked_align_equals_the_full_matrix_route(cuda_device, launches,
                                                    monkeypatch, size, letters,
                                                    kw):
    """Past the 64 MiB moves budget: one checkpoint launch, and a replay
    fill (routed) and a walk a block; strings, cost, score and report
    bytes == the same call with the budget raised (the full-matrix route);
    ``cost()`` == its cost, in one launch."""
    from globalign_tpu_torch import api

    s1, s2 = _long_pair(size, letters)
    call = dict(seq_1=s1, seq_2=s2, **kw)
    fills = _blocked_fills(len(s1), len(s2))
    launches()
    got = find_global_alignment(**call, device="cuda")
    assert launches() == _design(cuda_device, *fills, gotoh_tile=1,
                                 walk_block=len(fills))
    with monkeypatch.context() as patch:
        patch.setattr(api, "GotohAligner", functools.partial(
            GotohAligner, moves_budget_bytes=1 << 40))
        full = find_global_alignment(**call, device="cuda")
    assert got == full and str(got) == str(full)
    aligner = GotohAligner(validate_and_transform_args(**call).scheme,
                           device="cuda")
    launches()
    assert aligner.cost(s1, s2) == got.cost
    assert launches() == _design(cuda_device, _cost_fill(len(s1), len(s2)))


LETTERS_DESIGN = dict(letters_upload=1, tokenize_ragged=1, fetch=1)


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_align_pairs_on_a_chunk(cuda_device, launches, name, with_traceback):
    """``align_pairs`` on the runner's 1024-pair chunk (819-1024 letters):
    cost-only one gotoh_batch launch a width class, traceback one
    gotoh_batch_moves launch a width class, one walk and one render, each
    call one letters upload, one tokenize and one fetch; every fourth pair
    == the single-pair path on the card, every 64th (16 pairs across 14 of
    the chunk's 49 buckets) == device="cpu"."""
    letters, kw = SCHEMES[name]
    pairs = list(_chunk(letters))
    scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
    classes = {fill_batch.width_class(len(b)) for _, b in pairs}
    launches()
    got = align_pairs(pairs, scheme=scheme, with_traceback=with_traceback)
    assert launches() == (
        dict(batch_moves_warp=len(classes), walk_ragged=1, render_ragged=1,
             **LETTERS_DESIGN) if with_traceback
        else dict(batch_final3=len(classes), **LETTERS_DESIGN))
    aligner = GotohAligner(scheme, device="cuda")
    for (s1, s2), r in list(zip(pairs, got))[::4]:
        if with_traceback:
            assert _fields(r) == _fields(aligner.align(s1, s2))
        else:
            cost = aligner.cost(s1, s2)
            assert _fields(r) == (cost, final_cost_to_score(
                cost=cost, m=len(s1), n=len(s2), max_score=scheme.max_score),
                None, None, None)
    cpu = align_pairs(pairs[::64], scheme=scheme, with_traceback=with_traceback,
                      device="cpu")
    assert cpu == got[::64]


def _segments_of(pairs, budget, capacity):
    """align_pairs' traceback segments by its rule, as (m, n) lists: buckets
    in order of first appearance, each one's pairs in input order, a
    segment closed where its codes (``fill_cuda.ragged_bytes`` a pair)
    would pass ``capacity``; a bucket whose padded pair passes ``budget``
    goes blocked and joins none."""
    keys = {}
    for a, b in pairs:
        keys.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                        []).append((len(a), len(b)))
    segs, used = [[]], 0
    for key, shapes in keys.items():
        if fill_cuda.ragged_bytes(*key) > budget:
            continue
        for m, n in shapes:
            if used + fill_cuda.ragged_bytes(m, n) > capacity:
                segs.append([])
                used = 0
            segs[-1].append((m, n))
            used += fill_cuda.ragged_bytes(m, n)
    return [seg for seg in segs if seg]


@pytest.mark.parametrize("name", ["lowered budget", "one block",
                                  "both routes", "protein tail",
                                  "flush=False"])
def test_align_pairs_routes(cuda_device, launches, monkeypatch, name):
    """A lowered moves budget and segment capacity (three or more segments
    and a blocked pair, its replay blocks cut at the lowered capacity as
    ``batch._block_budget`` gives it); the same moves budget under a
    capacity that holds the blocked pair's codes whole (one replay block
    behind its checkpoint pass); a traceback call on both sides of 1024 columns
    (both fill routes, one walk); a cost-only BLOSUM62 call of the protein
    mix's lengths, its pairs past 1024 columns in one gotoh_tile launch;
    ``flush=False`` (the render queued, nothing fetched before
    ``resolve()``).  Each == device="cpu" or the single-pair path."""
    rng = np.random.default_rng(len(name))
    dna = len(resolve_scheme("ACGT", "ACGT").costing.values)
    if name in ("lowered budget", "one block"):
        pairs = list(_chunk("ACGT", 12, 290, 300))
        s1 = _seq(rng, "ACGT", 1200)
        pairs.insert(5, (s1, _relative(rng, s1, "ACGT")[:1100]))
        want = align_pairs(pairs)
        budget = 400_000
        capacity = budget if name == "lowered budget" else 2_000_000
        with monkeypatch.context() as patch:
            patch.setattr(batch_mod, "DEVICE_WALK_MOVES_BUDGET", budget)
            patch.setattr(batch_mod, "_segment_budget", lambda device: capacity)
            launches()
            got = align_pairs(pairs)
            moved = launches()
            blocks = _blocked_fills(
                1200, 1100, batch_mod._block_budget(cuda_device, None))
        segs = _segments_of(pairs, budget, capacity)
        routes = [fill_cuda.ragged_routes(*zip(*seg), dna, _sms(cuda_device))
                  for seg in segs]
        if name == "lowered budget":
            assert len(segs) >= 3 and len(blocks) >= 2
        else:
            assert len(blocks) == 1
        assert moved == _design(
            cuda_device, *blocks, gotoh_tile=1, walk_block=len(blocks),
            batch_moves_warp=sum(len(w) for w, _, _ in routes),
            batch_moves_ragged=sum(len(c) for _, c, _ in routes),
            walk_ragged=len(segs), render_ragged=len(segs), **LETTERS_DESIGN)
        assert got == want == align_pairs(pairs, device="cpu")
    elif name == "both routes":
        pairs = list(_chunk("ACGT", 12, 290, 1000))
        for k, size in ((2, 1100), (7, 2300), (9, 1500)):
            s1 = _seq(rng, "ACGT", size)
            pairs.insert(k, (s1, _relative(rng, s1, "ACGT")))
        launches()
        got = align_pairs(pairs)
        moved = launches()
        warp, classes, _ = fill_cuda.ragged_routes(
            [len(a) for a, _ in pairs], [len(b) for _, b in pairs], dna,
            _sms(cuda_device))
        assert warp and classes
        assert moved == dict(batch_moves_warp=len(warp),
                             batch_moves_ragged=len(classes), walk_ragged=1,
                             render_ragged=1, **LETTERS_DESIGN)
        aligner = GotohAligner(resolve_scheme("ACGT", "ACGT"), device="cuda")
        assert [_fields(r) for r in got] == [
            _fields(aligner.align(a, b)) for a, b in pairs]
        assert got == align_pairs(pairs, device="cpu")
    elif name == "protein tail":
        lengths = np.clip(np.round(300 * np.exp(0.6 * rng.standard_normal(256))),
                          30, 4000).astype(int).tolist()
        pairs = []
        for size in lengths + [1100, 2600, 3900]:
            s1 = _seq(rng, PROTEIN, size)
            pairs.append((s1, _relative(rng, s1, PROTEIN)))
        scheme = resolve_scheme(PROTEIN, PROTEIN, **BLOSUM)
        buckets = {}
        for a, b in pairs:
            key = (bucket_length(len(a)), bucket_length(len(b)))
            buckets.setdefault(key, ([], []))
            buckets[key][0].append(len(a))
            buckets[key][1].append(len(b))
        wide = [v for (_, n_cols), v in buckets.items()
                if n_cols > fill_batch.MAX_COLUMNS]
        assert fill_tile.route_buckets(wide, _sms(cuda_device)) == list(
            range(len(wide)))
        narrow = {fill_batch.width_class(len(b)) for _, b in pairs
                  if bucket_length(len(b)) <= fill_batch.MAX_COLUMNS}
        launches()
        got = align_pairs(pairs, scheme=scheme, with_traceback=False)
        assert launches() == dict(
            batch_final3=len(narrow), gotoh_tile=1, wide_launches=1,
            wide_pairs=sum(len(m) for m, _ in wide), **LETTERS_DESIGN)
        aligner = GotohAligner(scheme, device="cuda")
        assert [r.cost for r in got] == [aligner.cost(a, b) for a, b in pairs]
        some = pairs[:29] + pairs[-3:]  # the CPU's time: 32 pairs, the widest
        assert got[:29] + got[-3:] == align_pairs(
            some, scheme=scheme, with_traceback=False, device="cpu")
    else:
        pairs = list(_chunk("ACGT"))
        want = align_pairs(pairs)
        launches()
        pending = align_pairs(pairs, flush=False)
        moved = launches()
        assert "fetch" not in moved and (
            moved["render_ragged"], moved["tokenize_ragged"],
            moved["letters_upload"]) == (1, 1, 1)
        assert pending.resolve() == want


def _genome_call(count: int = 16):
    """``count`` pairs of 29 903 nt from the genome cell's traffic
    (``benchmark/traffic/sars2_genomes_tb.json``) and its scheme's
    keywords, BLAST+'s blastn."""
    from benchmark.harness import traffic

    bench = REPO / "benchmark"
    mix = json.loads((bench / "traffic" / "sars2_genomes_tb.json").read_text())
    kw = json.loads((bench / "configs" / "sars2_blastn.json").read_text())["scheme"]
    (pairs,) = traffic.generate({**mix, "pool_calls": 1, "pairs_per_call": count},
                                "ACGT", 2 ** 31 + 23)
    return pairs, kw


def test_genome_call_fills_its_last_wave_on_gotoh_tile(cuda_device, launches,
                                                       monkeypatch):
    """A call of 16 genomes (one traceback segment, one gotoh_fill launch
    class at W 16, 8 warps, 8 bands): the card holds fewer clusters of it
    than 16 (15 on an H100), so one gotoh_fill ragged launch fills 15 and
    one gotoh_tile launch with codes the 16th into the same buffer; equal
    to the same call with the split off (the cluster query patched to 16):
    final3, every byte of the codes, the walk, and every line of the
    call's results."""
    pairs, kw = _genome_call()
    scheme = resolve_scheme("ACGT", "ACGT", **kw)
    call, order = _pack_of(cuda_device, pairs, scheme)
    args = _fill_args(cuda_device, call, order, scheme)
    m = [x for ms in args[5] for x in ms]
    n = [x for ns in args[6] for x in ns]
    alphabet = args[2].shape[0]
    ((lp, _),) = fill_cuda.ragged_classes(m, n, _sms(cuda_device))
    clusters = fill_cuda._clusters(cuda_device.index or 0, alphabet, lp)
    assert fill_tile.route_tail(sorted(zip(m, n), key=lambda d: -d[0] * d[1]),
                                clusters, _sms(cuda_device)) == 1, clusters
    launches()
    wide = fill_cuda.batch_moves_ragged.wide_pairs
    split = fill_cuda.batch_moves_ragged(*args)
    split_walk = linear_tb.walk_ragged(split)
    assert launches() == dict(batch_moves_ragged=1, gotoh_tile=1, tile_launches=1,
                              tile_pairs=1, walk_ragged=1)
    assert fill_cuda.batch_moves_ragged.wide_pairs - wide == 15
    got = align_pairs(pairs, **kw)
    assert launches() == dict(batch_moves_ragged=1, gotoh_tile=1, tile_launches=1,
                              tile_pairs=1, walk_ragged=1, render_ragged=1,
                              **LETTERS_DESIGN)
    with monkeypatch.context() as patch:
        patch.setattr(fill_cuda, "_clusters", lambda index, alphabet, lp: 16)
        whole = fill_cuda.batch_moves_ragged(*args)
        whole_walk = linear_tb.walk_ragged(whole)
        assert launches() == dict(batch_moves_ragged=1, walk_ragged=1)
        want = align_pairs(pairs, **kw)
    assert torch.equal(split.final3, whole.final3)
    assert torch.equal(split.codes, whole.codes)
    for g, w in zip(split_walk, whole_walk):
        assert torch.equal(g, w)
    assert got == want
    del split, whole, split_walk, whole_walk
    torch.cuda.empty_cache()


@pytest.mark.slow
def test_align_pairs_mpox_genomes_match_the_reference(cuda_device, launches):
    """One call of the mpox cell (``mpox.batch_tb``: 2 genomes of 197 209 nt
    from its traffic, BLAST+'s blastn): each genome's codes (38.9 GB) pass
    the moves budget, so each takes the blocked route, one cost-only
    gotoh_tile checkpoint pass and 2 replay blocks at a quarter of the card
    (``batch._block_budget``), each one gotoh_tile launch with codes and
    one walk_block launch; no traceback segment, no upload, no fetch of a
    segment.  Costs, scores and the three lines equal the benchmark's
    plain reference on the card, a genome at a time (its codes in diagonal
    order: 72.4 GiB).  Slow: the reference takes minutes a genome."""
    from benchmark.reference import gotoh, scheme as ref_scheme

    pairs, scheme = _cell_call("mpox.batch_tb")
    budget = batch_mod._block_budget(cuda_device, None)
    fills = [f for a, b in pairs for f in _blocked_fills(len(a), len(b), budget)]
    assert len(fills) == 2 * 2
    assert _design(cuda_device, *fills) == {"gotoh_tile": len(fills)}
    before = (batch_mod.align_pairs.blocked_pairs, linear_tb.align_blocked.blocks,
              batch_mod.align_pairs.segments)
    launches()
    got = align_pairs(pairs, scheme=scheme)
    assert launches() == _design(cuda_device, *fills, gotoh_tile=len(pairs),
                                 walk_block=len(fills))
    after = (batch_mod.align_pairs.blocked_pairs, linear_tb.align_blocked.blocks,
             batch_mod.align_pairs.segments)
    assert [a - b for a, b in zip(after, before)] == [len(pairs), len(fills), 0]
    torch.cuda.empty_cache()
    config = json.loads((REPO / "benchmark" / "configs" / "mpox_blastn.json")
                        .read_text())
    costing = ref_scheme.resolve(config["scheme"], config["letters"])
    for pair, result in zip(pairs, got):
        (want,) = gotoh.align([pair], costing, traceback=True, device=cuda_device,
                              budget_bytes=8 << 30)
        assert _fields(result) == want
        torch.cuda.empty_cache()


def test_card_sized_blocks_past_byte_2_31_equal_the_strips(cuda_device,
                                                           launches,
                                                           monkeypatch):
    """A ~70 000^2 pair through ``align_pairs`` with ``_card_memory`` patched
    to 10 GB: its 4.9 GB of codes pass the 1536 MiB moves budget, so it goes
    blocked, in 2 blocks at a quarter of that card (2.5 GB), each past byte
    2^31 of codes and each one gotoh_tile launch with codes, after one
    checkpoint launch, and a walk a block.  Cost, score and lines equal the
    same pair's blocked route at 64 MiB (``GotohAligner.align``: ~74 strips
    of ~958 rows, each short and wide, so each a gotoh_fill launch), bit
    for bit."""
    s1, s2 = _long_pair(70_000, "ACGT")
    m, n = len(s1), len(s2)
    scheme = resolve_scheme(s1, s2)
    monkeypatch.setattr(batch_mod, "_card_memory", lambda index: 10_000_000_000)
    budget = batch_mod._block_budget(cuda_device, None)
    fills = _blocked_fills(m, n, budget)
    assert budget == 2_500_000_000 and len(fills) == 2
    assert all((k + 1) * (n + 1) > 2**31 for _, k, _, _, _ in fills)
    assert _design(cuda_device, *fills) == {"gotoh_tile": 2}
    launches()
    (got,) = align_pairs([(s1, s2)], scheme=scheme)
    assert launches() == {"gotoh_tile": 3, "walk_block": 2}
    strips = _blocked_fills(m, n)
    assert len(strips) > 60
    assert _design(cuda_device, *strips) == {"batch_moves": len(strips)}
    want = GotohAligner(scheme, device="cuda").align(s1, s2)
    assert launches() == _design(cuda_device, *strips, gotoh_tile=1,
                                 walk_block=len(strips))
    assert _fields(got) == (want.cost, want.score, want.seq_1_aligned,
                            want.middle_part, want.seq_2_aligned)


def _pack_of(dev, pairs, scheme):
    """align_pairs' pack of ``pairs`` on the card, uploaded and tokenized:
    (the packed call, the pairs in pack order)."""
    keys = {}
    for k, (a, b) in enumerate(pairs):
        keys.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                        []).append(k)
    spec = [([pairs[i][0] for i in idx], [pairs[i][1] for i in idx], m, n)
            for (m, n), idx in keys.items()]
    call = packed.pack_call(scheme.alphabet, spec, with_render=True, pin=True)
    call.upload(dev)
    call.tokenize()
    return call, [pairs[i] for idx in keys.values() for i in idx]


def _fill_args(dev, call, order, scheme):
    """The fill arguments of a packed call's buckets, as align_pairs passes
    them: (tok_a list, tok_b list, cost, gap_id, gap_open, m lists, n lists)."""
    cost = torch.from_numpy(np.ascontiguousarray(
        scheme.costing.values, dtype=np.int32)).to(dev)
    tas, tbs, mts, nts, row = [], [], [], [], 0
    for k, (_, _, nb, _, _) in enumerate(call.slots):
        ta, tb = call.bucket(k)
        tas.append(ta)
        tbs.append(tb)
        mts.append([len(a) for a, _ in order[row : row + nb]])
        nts.append([len(b) for _, b in order[row : row + nb]])
        row += nb
    return tas, tbs, cost, scheme.alphabet.gap_id, scheme.gap_open_cost, mts, nts


def _walked(dev, call, order, scheme):
    """The call's one traceback segment: (ops, count, j_exit) of its ragged
    fill and walk over the arena's buckets."""
    return linear_tb.walk_ragged(fill_cuda.batch_moves_ragged(
        *_fill_args(dev, call, order, scheme)))


def _tokens_equal(dev, call, shift=0):
    """tokenize_ragged into an arena of its own, its rows ``shift`` tokens
    in, == tokenize_plain (run on the card on the same tensors)."""
    want = packed.tokenize_plain(call.letters, call.table, call.token_desc,
                                 torch.zeros_like(call.arena))
    desc = call.token_desc.clone()
    desc[:, 2] += shift
    arena = torch.zeros(shift + call.arena_size, dtype=torch.int32, device=dev)
    packed.tokenize_ragged(call.letters, call.table, desc, arena)
    return torch.equal(arena[shift:], want)


def _render_equal(dev, call, walk, base=0):
    """render_ragged into a lines buffer of its own from letter ``base`` on
    == render_plain (on the card, same tensors), lines and ends."""
    ops, count, j_exit = walk
    lens = count.long() + j_exit.long()
    total = int(lens.sum())
    want = torch.zeros_like(call.lines())
    packed.render_plain(ops, count, j_exit, torch.cumsum(lens, 0) - lens,
                        call.letters, call.render_desc, want)
    got = torch.zeros((3, base + call.line_cap), dtype=want.dtype, device=dev)
    ends = packed.render_ragged(
        ops, count, j_exit, call.letters, call.render_desc, got,
        torch.tensor([base], dtype=torch.int64, device=dev))
    return torch.equal(got[:, base : base + total], want[:, :total]) and (
        torch.equal(ends.long() - base, torch.cumsum(lens, 0)))


@pytest.mark.parametrize("name", ["dna", "blosum62", "non-ASCII"])
def test_letters_kernels_on_a_chunk(cuda_device, tmp_path, name):
    """tokenize_ragged and render_ragged on a 1024-pair chunk packed as
    align_pairs packs it, its segment rendered from its own fill and walk:
    == the plain versions, and the lines == the numpy route's strings
    (the tapes fetched, ``linear_tb.render_many``)."""
    letters, kw = (("ΩЖ字A", _unicode_kw(tmp_path)) if name == "non-ASCII"
                   else SCHEMES[name])
    pairs = list(_chunk(letters))
    scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
    call, order = _pack_of(cuda_device, pairs, scheme)
    assert _tokens_equal(cuda_device, call)
    walk = _walked(cuda_device, call, order, scheme)
    assert _render_equal(cuda_device, call, walk)
    lines = call.lines()
    ends = packed.render_ragged(*walk, call.letters, call.render_desc, lines)
    host_lines, host_ends = batch_mod._to_host([lines, ends])
    tapes, counts, j_exits = (x.cpu().numpy() for x in walk)
    forward = [np.concatenate((np.full(j_exits[k], linear_tb.OP_LEFT, np.uint8),
                               tapes[k, : counts[k]][::-1]))
               for k in range(len(order))]
    assert packed.decode_lines(host_lines, host_ends, call.wide) == (
        linear_tb.render_many(forward, [a for a, _ in order],
                              [b for _, b in order]))


@pytest.mark.parametrize("buffer", ["codes", "tile codes", "tokens", "lines"])
def test_offsets_past_byte_2_31(cuda_device, buffer):
    """int64 offsets end to end: a ragged fill's pair placed past byte 2^31
    of a 2.2 GB codes buffer (fill and walk == plain, one
    gotoh_batch_moves launch), and gotoh_tile's codes there (one
    ``fill_tile.launch_codes`` launch == plain, nothing written outside
    the pairs' regions); a chunk's token rows past byte 2^31 of a 2.2 GB
    arena; its lines past byte 2^31 of a 3.2 GB lines buffer."""
    if buffer == "tile codes":
        args = _ragged_args([_case(np.random.default_rng(33), "ACGT",
                                   [(700, 650), (1000, 1000)])])
        _assert_tile_codes_equal(cuda_device, args, dict(
            offsets=[16, 2**31 + 4096], nbytes=2_200_000_000))
        return
    if buffer == "codes":
        args = _ragged_args([_case(np.random.default_rng(31), "ACGT",
                                   [(700, 650), (1000, 1000)])])
        place = dict(offsets=[16, 2**31 + 4096], nbytes=2_200_000_000)
        want = fill_cuda.batch_moves_ragged(*args, **place)
        before = fill_batch.batch_moves_warp.launches
        got = fill_cuda.batch_moves_ragged(*_ragged_on(cuda_device, args), **place)
        walk = linear_tb.walk_ragged(got)
        torch.cuda.synchronize()
        assert fill_batch.batch_moves_warp.launches == before + 1
        assert int(got.layout[:, 4].max()) > 2**31
        _assert_ragged_equal(got, want)
        for g, w in zip(walk, linear_tb.walk_ragged(want)):
            assert torch.equal(g.cpu(), w)
        return
    pairs = list(_chunk("ACGT"))
    scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)))
    call, order = _pack_of(cuda_device, pairs, scheme)
    if buffer == "tokens":
        assert _tokens_equal(cuda_device, call, shift=(1 << 29) + 64)
    else:
        assert _render_equal(cuda_device, call,
                             _walked(cuda_device, call, order, scheme),
                             base=(1 << 30) + 4096)


def test_batch_cli_on_the_card(cuda_device, tmp_path):
    """The batch CLI with traceback and CIGARs: ``--device cuda`` ==
    ``--device cpu`` (the results TSV byte for byte, the manifest
    fingerprints); ``--shard`` (an NCCL world of one) and, over 2 gloo
    processes on the card, ``--distributed`` with and without ``--shard``
    merge to the same TSV.  All seven processes run at once."""
    pairs = _chunk("ACGT", 128, 50, 300)
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in pairs))
    base = [sys.executable, "-m", "globalign_tpu_torch.batch_cli",
            "--pairs_tsv", str(tsv), "--with_traceback", "--cigar"]
    runs = [("cuda", base + ["-o", str(tmp_path / "cuda.tsv"), "--device", "cuda"]),
            ("cpu", base + ["-o", str(tmp_path / "cpu.tsv"), "--device", "cpu"]),
            ("shard", base + ["-o", str(tmp_path / "shard.tsv"), "--shard"])]
    for k, extra in enumerate(([], ["--shard"])):
        runs += [(f"dist{k}", base + [
            "-o", str(tmp_path / f"dist{k}.tsv"), "--distributed", "--backend",
            "gloo", "--coordinator_address", f"file://{tmp_path / f'store{k}'}",
            "--num_processes", "2", "--process_id", str(rank), "--chunk_pairs",
            "32", *extra]) for rank in range(2)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [(name, subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE))
             for name, cmd in runs]
    try:
        errors = [proc.communicate(timeout=600)[1] for _, proc in procs]
    finally:
        for _, proc in procs:
            proc.kill()
    for (name, proc), err in zip(procs, errors):
        assert proc.returncode == 0, f"{name}: {err[-3000:]}"
    card = (tmp_path / "cuda.tsv").read_bytes()
    assert len(card.splitlines()) == len(pairs)
    assert card == (tmp_path / "cpu.tsv").read_bytes()
    prints = [{json.loads(line)["fingerprint"] for line in (
        tmp_path / f"{device}.tsv.manifest.jsonl").read_text().splitlines()}
        for device in ("cuda", "cpu")]
    assert prints[0] == prints[1]
    assert (tmp_path / "shard.tsv").read_bytes() == card
    for k in range(2):
        rows = [line for part in sorted(tmp_path.glob(f"dist{k}.tsv*"))
                if not part.name.endswith(".jsonl")
                for line in part.read_text().splitlines(keepends=True)]
        merged = sorted(rows, key=lambda line: int(line.split("\t")[0]))
        assert "".join(merged).encode() == card


@pytest.mark.parametrize("with_traceback", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_world_of_one_on_a_chunk(cuda_device, world_of_one, launches, name,
                                 with_traceback):
    """``align_pairs(mesh=)`` over an NCCL world of one on the 1024-pair
    chunk == the unsharded call, pair by pair; the mesh path keeps a
    launch a bucket shard (cost-only a gotoh_batch launch, traceback a
    moves fill and a walk_block launch) and one fetch."""
    letters, kw = SCHEMES[name]
    pairs = list(_chunk(letters))
    scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)), **kw)
    want = align_pairs(pairs, scheme=scheme, with_traceback=with_traceback)
    launches()
    got = align_pairs(pairs, scheme=scheme, with_traceback=with_traceback,
                      mesh=world_of_one)
    moved = launches()
    buckets = {}
    for a, b in pairs:
        buckets.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                           []).append((len(a), len(b)))
    if with_traceback:
        fills = []
        for key, shapes in buckets.items():
            per = batch_mod.DEVICE_WALK_MOVES_BUDGET // fill_cuda.ragged_bytes(*key)
            for lo in range(0, len(shapes), per):
                group = shapes[lo : lo + per]
                fills.append((len(group), max(m for m, _ in group),
                              max(n for _, n in group), True, "batch_moves"))
        assert moved == _design(cuda_device, *fills, walk_block=len(fills),
                                fetch=1)
    else:
        assert moved == dict(batch_final3=len(buckets), fetch=1)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]


LONG_COSTS = [(50_000, "ACGT", {}), (20_000, PROTEIN, BLOSUM)]


def _pair_cost_args(size, letters, kw):
    s1, s2 = _long_pair(size, letters)
    aligner = GotohAligner(resolve_scheme(s1, s2, **kw), device="cuda")
    return aligner, (aligner._encode(s1), aligner._encode(s2), aligner.cost_mat,
                     aligner.gap_id, aligner.gap_open)


@pytest.mark.parametrize("size,letters,kw", LONG_COSTS)
def test_world_of_one_pair_cost_at_long_pair_sizes(world_of_one, launches,
                                                   size, letters, kw):
    """``sharded_pair_cost`` on an NCCL world of one: a strip-mode launch a
    block, the cost == ``cost()`` (the split)."""
    from globalign_tpu_torch.parallel import seqpar

    aligner, enc = _pair_cost_args(size, letters, kw)
    launches()
    final3 = seqpar.sharded_pair_cost(world_of_one, *enc)
    assert launches() == dict(
        strip_fill_block=-(-size // seqpar.DEFAULT_BLOCK_ROWS))
    assert int(final3.min()) == aligner.cost(*_long_pair(size, letters))


def test_four_gloo_ranks_share_the_card(world_of_one, tmp_path):
    """Four gloo ranks on one card (their exchanges staged through host
    memory), every rank: ``sharded_pair_cost`` on the 50 000^2 DNA and
    20 000^2 BLOSUM62 pairs == the NCCL world of one's lanes, a strip
    launch a block; ``align_blocked(mesh=)`` at 20 000^2 == the unsharded
    blocked path (strings, cost, score, report bytes), a strip launch a
    block of its checkpoint pass's pipeline; ``align_pairs(mesh=)`` on the
    DNA chunk, both modes, == the unsharded call."""
    from globalign_tpu_torch.parallel import seqpar
    from tests.torch_dist_harness import run_ranks, strip_launches

    cases, want = [], []
    for size, letters, kw in LONG_COSTS:
        _, enc = _pair_cost_args(size, letters, kw)
        cases.append(dict(
            kind="pair_cost", device="cuda", tok_a=enc[0].tolist(),
            tok_b=enc[1].tolist(), cost=enc[2].tolist(), gap_id=enc[3],
            gap_open=enc[4], block_rows=seqpar.DEFAULT_BLOCK_ROWS))
        want.append((seqpar.sharded_pair_cost(world_of_one, *enc).tolist(),
                     -(-size // seqpar.DEFAULT_BLOCK_ROWS)))
    s1, s2 = _long_pair(20_000, "ACGT")
    blocked = find_global_alignment(seq_1=s1, seq_2=s2, device="cuda")
    bounds = linear_tb.block_bounds(len(s1), len(s2))
    want.append((blocked, sum(-(-(hi - lo) // min(seqpar.DEFAULT_BLOCK_ROWS,
                                                  hi - lo))
                              for lo, hi in zip(bounds, bounds[1:]))))
    cases.append(dict(kind="align_blocked", device="cuda", s1=s1, s2=s2))
    pairs = list(_chunk("ACGT"))
    for with_traceback in (False, True):
        cases.append(dict(kind="align_pairs", device="cuda", pairs=pairs,
                          traceback=with_traceback))
        want.append(([list(_fields(r)) for r in align_pairs(
            pairs, with_traceback=with_traceback)], 0))
    max_score = resolve_scheme(s1, s2).max_score
    for answers, strips in zip(run_ranks(tmp_path, 4, cases, timeout=900),
                               strip_launches(tmp_path, 4)):
        cost, s1a, mid, s2a = answers[2]
        answers[2] = blocked._replace(
            seq_1_aligned=s1a, middle_part=mid, seq_2_aligned=s2a, cost=cost,
            score=final_cost_to_score(cost=cost, m=len(s1), n=len(s2),
                                      max_score=max_score))
        assert answers == [w for w, _ in want]
        assert str(answers[2]) == str(blocked)
        assert strips == [k for _, k in want]


@pytest.mark.parametrize("size", [10_000, 50_000])
def test_wave_split_cost_at_long_pair_sizes(cuda_device, launches, size):
    """``wave_split_fill_cost`` (TPU kernel #9's entry point): one launch,
    == ``cost()`` (the row split) and, at 10 000^2, the direct fill."""
    s1, s2 = _long_pair(size, "ACGT")
    aligner = GotohAligner(resolve_scheme(s1, s2), device="cuda")
    prm = fill_wave.uniform_scheme_params(aligner.scheme.costing.values,
                                          aligner.gap_id)
    launches()
    cost = int(fill_wave.wave_split_fill_cost(
        aligner._encode(s1), aligner._encode(s2), *prm, aligner.gap_open,
        len(s1), len(s2)))
    assert launches() == dict(wave_frontiers=1)
    assert cost == aligner.cost(s1, s2)
    if size <= 10_000:
        direct, _ = aligner._batch_fill(s1, s2, want_moves=False)
        assert cost == int(direct.min())


def test_batch_final3_dual_on_a_chunks_widest_buckets(cuda_device, launches):
    """``batch_final3_dual`` (TPU kernel #11's entry point) on the DNA
    chunk's two widest buckets, a set each: one launch, every pair's cost
    == ``align_pairs``'."""
    from globalign_tpu_torch.utils.tokenize import encode_padded

    pairs = list(_chunk("ACGT"))
    scheme = resolve_scheme(*("".join(s) for s in zip(*pairs)))
    groups = {}
    for k, (a, b) in enumerate(pairs):
        groups.setdefault((bucket_length(len(a)), bucket_length(len(b))),
                          []).append(k)
    widest = sorted(groups, key=lambda key: (key[1], key[0]))[-2:]
    per_set = min(len(groups[key]) for key in widest)
    ids = [groups[key][:per_set] for key in widest]
    rows, cols = (max(key[side] for key in widest) for side in (0, 1))

    def tokens(side, width):
        return torch.from_numpy(np.stack([
            [encode_padded(scheme.alphabet, pairs[k][side], width) for k in i]
            for i in ids])).to(cuda_device)

    cost = torch.from_numpy(np.ascontiguousarray(scheme.costing.values,
                                                 dtype=np.int32))
    launches()
    final3 = fill_batch.batch_final3_dual(
        tokens(0, rows), tokens(1, cols), cost.to(cuda_device),
        scheme.alphabet.gap_id, scheme.gap_open_cost,
        [[len(pairs[k][0]) for k in i] for i in ids],
        [[len(pairs[k][1]) for k in i] for i in ids])
    assert launches() == dict(batch_final3=1)
    costs = align_pairs(pairs, scheme=scheme, with_traceback=False)
    assert final3.min(-1).values.tolist() == [[costs[k].cost for k in i]
                                              for i in ids]


def test_compat_on_the_card(cuda_device, launches, tmp_path):
    """``globalign_tpu_torch.compat`` called as code written against the
    reference calls it, with no device argument (so the card): the
    goldens, and a 4472^2 DNA and a 4472 x 4471 BLOSUM62 pair at the
    reference's input limit, == device="cpu" (one fill and one walk a
    pair; == ``cost()``); ``start``'s refusal at 4473 x 4472 beside
    ``find_global_alignment`` running it; ``globaligner.main``'s report
    bytes == the port's CLI on the CPU; ``dp_compat``'s interpreted 200^2
    fill == the card's cost."""
    from globalign_tpu_torch import cli as torch_cli
    from globalign_tpu_torch import compat

    def one_align(m, n):  # one fill and one walk
        return _design(cuda_device, (1, m, n, True, "batch_moves"), walk_block=1)

    goldens = _single_runs("goldens", tmp_path)
    want = [find_global_alignment(**kw, device="cpu") for kw, _ in goldens]
    launches()
    got = [compat.globaligner.find_global_alignment(**kw) for kw, _ in goldens]
    assert launches() == _design(cuda_device, *[
        (1, len(kw["seq_1"]), len(kw["seq_2"]), True, "batch_moves")
        for kw, _ in goldens], walk_block=len(goldens))
    assert got == want and [str(r) for r in got] == [str(w) for w in want]
    assert [(r.score, r.cost) for r in got] == [g for _, g in goldens]
    rng = np.random.default_rng(9)
    s1 = _seq(rng, "ACGT", 4472)
    limit = [dict(seq_1=s1, seq_2=_relative(rng, s1, "ACGT"))]
    s1 = _seq(rng, PROTEIN, 4472)
    limit.append(dict(seq_1=s1, seq_2=_relative(rng, s1, PROTEIN)[:4471], **BLOSUM))
    for kw in limit:
        want_r = find_global_alignment(**kw, device="cpu")
        launches()
        r = compat.globaligner.find_global_alignment(**kw)
        assert launches() == one_align(len(kw["seq_1"]), len(kw["seq_2"]))
        aligner = GotohAligner(validate_and_transform_args(**kw).scheme,
                               device="cuda")
        assert r == want_r and str(r) == str(want_r)
        assert r.cost == aligner.cost(kw["seq_1"], kw["seq_2"])
    s1 = _seq(rng, "ACGT", 4473)
    past = dict(seq_1=s1, seq_2=_relative(rng, s1, "ACGT")[:4472])
    with pytest.raises(RuntimeError, match="too long"):
        compat.start.validate_and_transform_args(**past)
    compat.start.validate_and_transform_args(**limit[0])
    launches()
    r = compat.find_global_alignment(**past)
    assert launches() == one_align(4473, 4472)
    assert r.cost == GotohAligner(validate_and_transform_args(**past).scheme,
                                  device="cuda").cost(past["seq_1"], past["seq_2"])
    s1 = _seq(rng, PROTEIN, 1500)
    fasta = tmp_path / "pair.fasta"
    fasta.write_text(f">a\n{s1}\n>b\n{_relative(rng, s1, PROTEIN)[:1400]}\n")
    argv = ["-i", str(fasta), "--scoring_mat_name", "BLOSUM62"]
    torch_cli.main(argv + ["--device", "cpu", "-o", str(tmp_path / "cpu.txt")])
    launches()
    compat.globaligner.main(argv + ["-o", str(tmp_path / "card.txt")])
    assert launches() == one_align(1500, 1400)
    assert (tmp_path / "card.txt").read_bytes() == (tmp_path / "cpu.txt").read_bytes()
    s1 = _seq(rng, "ACGT", 200)
    s2 = _relative(rng, s1, "ACGT")
    r = compat.find_global_alignment(seq_1=s1, seq_2=s2)
    costing, go = r.costing_mat, r.gap_open_cost
    dp = compat.globaligner.make_dp_array(s1, s2, costing,
                                          compat.start.get_max_val(costing), go)
    compat.globaligner.dp_array_forward(dp, s1, s2, costing, go)
    assert compat.globaligner.dp_array_backward(dp, s1, s2, costing, go)[3] == r.cost



# -- each cell's kernels against their bounds ---------------------------------
#
# Every kernel instance a cell's device trace shows, timed at that cell's
# shapes on its own traffic (device time, from the benchmark's tracer) and
# held to a bound it cannot beat: the true cells at the roofline's ceiling
# (``benchmark/harness/peaks.py``), the bytes it must write or read at the
# HBM's peak, or its longest walk at one step a clock.  Each case prints one
# JSON line, a row a kernel: ``ms``, ``bound_ms`` and ``bound_by``,
# ``plain_ms`` (its plain version on the host CPU, or on the card where
# named; a fill's over each bucket's first PLAIN_ROWS rows, scaled to all
# its rows) and ``library_ms`` (no library on the card fills, walks or
# renders a Gotoh alignment: null).  Show the lines with ``-rP``.

HBM_BYTES_S = 3.35e12  # H100 SXM5's HBM3 peak (NVIDIA's datasheet)
PLAIN_ROWS = 4
CELL_CONFIGS = {"dna.pair_align": ("dna_wfa", "wfa_10k_pair"),
                "protein.batch_cost": ("protein_blosum62", "protein_rv12_cost"),
                "sars2.batch_tb": ("sars2_blastn", "sars2_genomes_tb"),
                "mpox.batch_tb": ("mpox_blastn", "mpox_genomes_tb")}
KERNEL_FAMILIES = ("gotoh_", "walk_", "wave_split", "render_kernel",
                   "tokenize_kernel")


def _cell_call(cell: str):
    """A cell's first call from its traffic file (seed 7) and its scheme."""
    from benchmark.harness import traffic

    bench = REPO / "benchmark"
    config, mix = CELL_CONFIGS[cell]
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    spec = json.loads((bench / "traffic" / f"{mix}.json").read_text())
    (pairs,) = traffic.generate({**spec, "pool_calls": 1}, cfg["letters"], 7)
    return pairs, resolve_scheme(cfg["letters"], cfg["letters"], **cfg["scheme"])


def _traced_ms(fn, reps: int) -> tuple[dict, int]:
    """Device ms a call of every kernel of the port's sources that ``fn``
    launches, and its launches a call, over ``reps`` calls after one
    warm-up, keyed by the trace's name without spaces, namespace and
    arguments (``gotoh_tile_kernel<64,4,true,true>``); and the count of
    every kernel the window recorded."""
    from benchmark.harness import trace

    fn()
    traced = trace.Slice()
    with trace.profiled(traced):
        for _ in range(reps):
            fn()
    out = collections.defaultdict(lambda: [0.0, 0])
    for kind, name, start, end in traced.events:
        key = name.replace(" ", "")
        key = key[key.find("::") + 2 :].split("(")[0] if "::" in key else key
        if kind == "kernel" and key.startswith(KERNEL_FAMILIES):
            out[key][0] += (end - start) / 1e6 / reps
            out[key][1] += 1
    recorded = sum(kind == "kernel" for kind, *_ in traced.events)
    return {k: (ms, n / reps) for k, (ms, n) in out.items()}, recorded


def _host_ms(fn) -> float:
    """Wall ms of ``fn`` and what it queued, after one untimed call."""
    fn()
    return _wall_ms(fn)


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _plain_fill_ms(fill, tas, tbs, cost, gap_id, gap_open, mts, nts) -> float:
    """``fill`` (a ragged wrapper) on the host over each bucket's first
    PLAIN_ROWS rows, each bucket's time scaled by its rows over those."""
    total = 0.0
    for ta, tb, ms, ns in zip(tas, tbs, mts, nts):
        rows = min(PLAIN_ROWS, ta.shape[1] - 1)
        if rows:
            cut = ta[:, : rows + 1].cpu().contiguous()
            total += _wall_ms(lambda: fill(
                [cut], [tb.cpu()], cost.cpu(), gap_id, gap_open,
                [[min(m, rows) for m in ms]], [ns])) * (ta.shape[1] - 1) / rows
    return total


def _row(want, name, shape, plain, **work):
    """Add a launch's work (cells, bytes, steps), shape and plain version
    to kernel instance ``name``'s row of ``want``."""
    row = want.setdefault(name, dict(cells=0, bytes=0, steps=0, shape=[], plain=[]))
    for k, v in work.items():
        row[k] += v
    row["shape"].append(shape)
    row["plain"].append(plain)


def _pair_cell(dev, pairs, scheme):
    """dna.pair_align's request past the moves budget: the checkpoint pass,
    then each block's replay fill and walk, the bottom block first
    (``linear_tb.align_blocked``)."""
    ((s1, s2),) = pairs
    m, n = len(s1), len(s2)
    ta, tb, cost, gid, go, _, _ = _on(dev, _args(scheme, pairs))
    bounds = linear_tb.block_bounds(m, n, block_moves_bytes=DEFAULT_MOVES_BUDGET_BYTES)
    blocks = list(zip(bounds, bounds[1:]))[::-1]
    sms = _sms(dev)
    walks = []

    def request():
        fill_tile.checkpoint_rows(ta[0], tb[0], cost, gid, go, bounds[1:])
        j = torch.full((1,), n, dtype=torch.int32, device=dev)
        level = None
        for i0, i1 in blocks:
            final3, moves = fill_cuda.batch_moves(
                ta[:, i0 : i1 + 1].contiguous(), tb, cost, gid, go, [i1 - i0], [n])
            if level is None:
                level = final3[0].argmin().to(torch.int32).reshape(1)
            walks.append((moves, j, level))
            _, count, j, level = linear_tb.walk_block(moves, [i1 - i0], j, level)
            walks[-1] += (int(count),)

    request()
    want = {}
    h, w = fill_tile.plan([(m, n)], False, sms)
    _row(want, f"gotoh_tile_kernel<{h},{w},false,true>",
         f"{m} x {n} cost only, rows {bounds[1:]}",
         lambda: _plain_fill_ms(fill_batch.batch_final3_ragged, [ta], [tb], cost,
                                gid, go, [[m]], [[n]]), cells=m * n)
    for (i0, i1), (moves, j, level, steps) in zip(blocks, walks):
        assert fill_tile.route(1, i1 - i0, n, True, sms)
        h, w = fill_tile.plan([(i1 - i0, n)], True, sms)
        _row(want, f"gotoh_tile_kernel<{h},{w},true,true>",
             f"replay block {i1 - i0} x {n} with codes",
             lambda i0=i0, i1=i1: _plain_fill_ms(
                 fill_cuda.batch_moves_ragged, [ta[:, i0 : i1 + 1]], [tb], cost,
                 gid, go, [[i1 - i0]], [[n]]),
             cells=(i1 - i0) * n, bytes=(i1 - i0 + 1) * (n + 1))
        _row(want, "walk_block_kernel", f"{steps} steps",
             lambda moves=moves.cpu(), k=i1 - i0, j=j.cpu(), level=level.cpu():
             _host_ms(lambda: linear_tb.walk_block(moves, [k], j, level)),
             steps=steps)
    want["walk_block_kernel"]["plain_note"] = "the plain walk on the host"
    walks.clear()
    return request, want


def _blocked_cell(dev, pairs, scheme):
    """mpox.batch_tb's call: ``align_pairs`` sends each genome down the
    blocked route (``linear_tb.align_blocked``), a checkpoint pass on
    gotoh_tile, then each block's replay (blocks at ``batch._block_budget``:
    2 a genome, each on gotoh_tile) and its walk.  The plain versions run on
    the first genome: its fills over PLAIN_ROWS rows scaled to every cell of
    the call, the walk of its top 512 rows on the host scaled to the call's
    steps."""
    out = {}

    def run():
        out["results"] = align_pairs(pairs, scheme=scheme, device=dev)

    run()
    sms, want = _sms(dev), {}
    ta, tb, cost, gid, go, (m0,), (n0,) = _on(dev, _args(scheme, pairs[:1]))
    rate = {codes: functools.cache(lambda fill=fill: _plain_fill_ms(
        fill, [ta], [tb], cost, gid, go, [[m0]], [[n0]]) / (m0 * n0))
        for codes, fill in ((False, fill_batch.batch_final3_ragged),
                            (True, fill_cuda.batch_moves_ragged))}
    h, w = fill_tile.plan([(m0, n0)], False, sms)
    budget = batch_mod._block_budget(dev, None)
    for a, b in pairs:
        m, n = len(a), len(b)
        assert fill_tile.plan([(m, n)], False, sms) == (h, w)
        _row(want, f"gotoh_tile_kernel<{h},{w},false,true>",
             f"{m} x {n} cost only, checkpoint rows",
             lambda c=m * n: rate[False]() * c, cells=m * n)
        bounds = linear_tb.block_bounds(m, n, block_moves_bytes=budget)
        for k in (i1 - i0 for i0, i1 in zip(bounds, bounds[1:])):
            assert fill_tile.route(1, k, n, True, sms)
            rh, rw = fill_tile.plan([(k, n)], True, sms)
            _row(want, f"gotoh_tile_kernel<{rh},{rw},true,true>",
                 f"replay block {k} x {n} with codes",
                 lambda c=k * n: rate[True]() * c, cells=k * n,
                 bytes=(k + 1) * (n + 1))
    top = linear_tb.DEFAULT_BLOCK_ROWS
    final3, moves = fill_cuda.batch_moves(ta[:, : top + 1].contiguous(), tb, cost,
                                          gid, go, [top], [n0])
    moves, level = moves.cpu(), final3[0].argmin().to(torch.int32).reshape(1).cpu()
    start = torch.tensor([n0], dtype=torch.int32)
    top_steps = int(linear_tb.walk_block(moves, [top], start, level)[1])
    # a walk stops at row 0: the leading gaps of seq_1's line are not its
    steps = sum(len(r.seq_1_aligned.lstrip("-")) for r in out["results"])
    _row(want, "walk_block_kernel", f"{steps} steps",
         lambda: steps / top_steps * _host_ms(
             lambda: linear_tb.walk_block(moves, [top], start, level)),
         steps=steps)
    want["walk_block_kernel"]["plain_note"] = (
        "the first genome's top 512 rows walked on the host, scaled to the "
        "call's steps")
    for name in want:
        if name.startswith("gotoh_tile"):
            want[name]["plain_note"] = (
                "the host's row scan on the first genome, by cells")
    return run, want


def _batch_cell(dev, pairs, scheme, with_traceback):
    """An align_pairs call's kernels over its pack (its buckets): the
    tokenize, then the cost fill, or the moves fill, the walk and the
    render of its one traceback segment."""
    call, order = _pack_of(dev, pairs, scheme)
    args = _fill_args(dev, call, order, scheme)
    tas, tbs, cost, gid, go, mts, nts = args
    letters = sum(len(a) + len(b) for a, b in pairs)
    lines = call.lines() if with_traceback else None
    out = {}

    def run():
        call.tokenize()
        if not with_traceback:
            fill_batch.batch_final3_ragged(*args)
            return
        filled = fill_cuda.batch_moves_ragged(*args)
        out["walk"] = linear_tb.walk_ragged(filled)
        out["final3"], out["layout"] = filled.final3, filled.layout
        packed.render_ragged(*out["walk"], call.letters, call.render_desc, lines)

    run()
    want, sms, alphabet = {}, _sms(dev), cost.shape[0]
    _row(want, "tokenize_kernel", f"{len(pairs)} pairs, {letters} letters",
         lambda: _host_ms(lambda: packed.tokenize_plain(
             call.letters, call.table, call.token_desc, torch.zeros_like(call.arena))),
         bytes=5 * letters)  # a letter's byte in, its int32 token out
    want["tokenize_kernel"]["plain_note"] = "tokenize_plain on the card"
    cells = [sum(m * n for m, n in zip(ms, ns)) for ms, ns in zip(mts, nts)]
    bucket_plain = lambda fill, k: lambda: _plain_fill_ms(  # noqa: E731
        fill, [tas[k]], [tbs[k]], cost, gid, go, [mts[k]], [nts[k]])
    if not with_traceback:
        wide = [k for k, tb in enumerate(tbs)
                if fill_batch.plan(tb.shape[1] - 1, alphabet) is None]
        for k, tb in enumerate(tbs):
            if k not in wide:
                width = fill_batch.plan(tb.shape[1] - 1, alphabet)
                _row(want, f"gotoh_batch_kernel<{width},false",
                     f"{len(mts[k])} x {tas[k].shape[1] - 1} x {tb.shape[1] - 1}",
                     bucket_plain(fill_batch.batch_final3_ragged, k), cells=cells[k])
        if wide:
            assert fill_tile.route_buckets([(mts[k], nts[k]) for k in wide],
                                           sms) == list(range(len(wide)))
            h, w = fill_tile.plan([d for k in wide for d in zip(mts[k], nts[k])],
                                  False, sms)
            for k in wide:
                _row(want, f"gotoh_tile_kernel<{h},{w},false,true>",
                     f"{len(mts[k])} x {tas[k].shape[1] - 1} x {tbs[k].shape[1] - 1}",
                     bucket_plain(fill_batch.batch_final3_ragged, k), cells=cells[k])
        return run, want
    m_all = [m for ms in mts for m in ms]
    n_all = [n for ns in nts for n in ns]
    warp, classes, tails = fill_cuda.ragged_routes(
        m_all, n_all, alphabet, sms,
        functools.partial(fill_cuda._clusters, dev.index or 0, alphabet))
    ((lp, idx),) = classes  # the call's genomes in one launch class
    assert not warp and len(idx) + sum(len(t) for t in tails) == len(m_all)
    cells = sum(m * n for m, n in zip(m_all, n_all))
    plain = functools.cache(  # the call's fill on the host, shared by cells
        lambda: _plain_fill_ms(fill_cuda.batch_moves_ragged, *args) / cells)

    def fill_row(name, shape, ks):
        part = sum(m_all[k] * n_all[k] for k in ks)
        _row(want, name, shape, lambda: plain() * part, cells=part,
             bytes=sum((m_all[k] + 1) * (n_all[k] + 1) for k in ks))

    fill_row(f"gotoh_fill_kernel<{lp[0]},true,true,true>",
             f"{len(idx)} pairs, {lp[1]} warps, {lp[2]} bands, {lp[3]} passes",
             idx.tolist())
    for tail in tails:  # the pairs its clusters leave to a last wave
        h, w = fill_tile.plan([(m_all[k], n_all[k]) for k in tail], True, sms)
        fill_row(f"gotoh_tile_kernel<{h},{w},true,true>",
                 f"{len(tail)} pairs, codes into the ragged fill", tail.tolist())
    ops, count, j_exit = out["walk"]
    lo, ld = (int(x) for x in out["layout"][0, 4:6])
    m0, n0 = m_all[0], n_all[0]
    codes0 = fill_cuda.batch_moves_ragged(*args).codes[lo : lo + (m0 + 1) * ld]
    codes0 = codes0.view(m0 + 1, ld)[:, : n0 + 1].cpu().contiguous()[None]
    level0 = out["final3"][0].argmin().to(torch.int32).reshape(1).cpu()
    _row(want, "walk_ragged_kernel", f"{len(m_all)} walks, {int(count.sum())} steps",
         lambda: len(m_all) * _host_ms(lambda: linear_tb.walk_block(
             codes0, [m0], torch.tensor([n0], dtype=torch.int32), level0)),
         steps=int(count.max()))
    want["walk_ragged_kernel"]["plain_note"] = (
        "the first pair's walk on the host, times the pairs")
    lens = count.long() + j_exit.long()
    walked = int(lens.sum())
    _row(want, "render_kernel", f"{walked} columns of lines",
         lambda: _host_ms(lambda: packed.render_plain(
             ops, count, j_exit, torch.cumsum(lens, 0) - lens, call.letters,
             call.render_desc, torch.zeros_like(lines))),
         bytes=int(count.sum()) + letters + 3 * walked * lines.element_size())
    want["render_kernel"]["plain_note"] = "render_plain on the card"
    return run, want


def _cell_kernels(cell: str) -> dict:
    """A cell's kernel rows (the section's comment), each with ``rule``, the
    host rules' instance it matches (None where they pick none), beside
    ``picked``, every instance those rules pick."""
    from benchmark.harness import peaks

    dev = torch.device("cuda", 0)
    pairs, scheme = _cell_call(cell)
    if cell == "dna.pair_align":
        run, want = _pair_cell(dev, pairs, scheme)
    elif cell == "mpox.batch_tb":
        run, want = _blocked_cell(dev, pairs, scheme)
    else:
        run, want = _batch_cell(dev, pairs, scheme,
                                with_traceback=cell == "sars2.batch_tb")
    card = peaks.card()
    ceiling = peaks.ceiling_cells_per_s(**card)
    traced, recorded = _traced_ms(run, reps=2)
    rows = []
    for name, (ms, launches) in sorted(traced.items()):
        rule = next((prefix for prefix in want if name.startswith(prefix)), None)
        spec = want.get(rule, dict(cells=0, bytes=0, steps=0, shape=[], plain=[]))
        bound_ms, bound_by = max(
            (1e3 * spec["cells"] / ceiling, "operations"),
            (1e3 * spec["bytes"] / HBM_BYTES_S, "bytes"),
            (1e3 * spec["steps"] / (card["max_sm_mhz"] * 1e6), "latency"))
        rows.append(dict(name=name, rule=rule, shape="; ".join(spec["shape"]),
                         launches=launches, ms=ms, bound_ms=bound_ms,
                         bound_by=bound_by, plain_ms=sum(f() for f in spec["plain"]),
                         plain_note=spec.get("plain_note", "the host's row scan"),
                         library_ms=None))
    return dict(cell=cell, card=torch.cuda.get_device_name(dev),
                ceiling_cells_per_s=ceiling, kernel_events=recorded,
                picked=sorted(want), kernels=rows)


@pytest.fixture(scope="module")
def cell_kernels():
    """``cell_kernels(cell)``: the cell's ``_cell_kernels``, measured in a
    process of its own: late in a process the profiler lost the first
    kernels of its windows (on an H100 80GB HBM3: in this file's process,
    and in one child after the mpox cell's ~100 s), in a fresh one it lost
    none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.cuda.empty_cache()  # room for the child's 15 GB of genome codes
    code = ("import json, sys; from tests.test_torch_cuda import _cell_kernels; "
            "print(json.dumps(_cell_kernels(sys.argv[1])))")

    @functools.cache
    def measure(cell: str) -> dict:
        proc = subprocess.run([sys.executable, "-c", code, cell], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    return measure


@pytest.mark.parametrize("cell", sorted(CELL_CONFIGS))
def test_cell_kernels_against_their_bounds(cell_kernels, record_property, cell):
    """Each of the port's kernel instances that a cell's call launches is
    one its host rules pick, each they pick runs, every call launches each
    the same whole number of times, and none runs faster than its bound.
    Each row is printed beside its plain version's time."""
    line = cell_kernels(cell)
    assert sorted(row["rule"] or "" for row in line["kernels"]) == line["picked"], line
    for row in line["kernels"]:
        assert row["launches"] >= 1 and float(row["launches"]).is_integer(), row
        assert 0 < row["bound_ms"] <= row["ms"], row
    record_property("kernels", json.dumps(line))
    print(json.dumps(line))

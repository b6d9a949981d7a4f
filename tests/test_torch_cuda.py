"""The CUDA kernel against its plain version — needs an NVIDIA GPU.

Every test here is marked ``cuda`` and skips (inside the ``cuda_device``
fixture) where no CUDA device is present.  This file imports neither JAX
nor the JAX package, so on a machine with the card and without JAX it runs
alone:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q

Tolerance 0: final3, last rows, move codes, op tapes and costs are
integers, and alignments are strings.
"""

import numpy as np
import pytest
import torch

from globalign_tpu_torch import GotohAligner, find_global_alignment, resolve_scheme
from globalign_tpu_torch.ops import fill_cuda, fill_split, fill_tile, linear_tb

pytestmark = pytest.mark.cuda

TABLE_LETTERS = "".join(chr(0x4E00 + k) for k in range(399))  # a 640 KB table


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
    ta = np.zeros((len(pairs), max(m for m, _ in shapes) + 1), np.int32)
    tb = np.zeros((len(pairs), max(n for _, n in shapes) + 1), np.int32)
    for b, (s1, s2) in enumerate(pairs):
        ta[b, 1 : len(s1) + 1] = scheme.alphabet.encode(s1)
        tb[b, 1 : len(s2) + 1] = scheme.alphabet.encode(s2)
    cost = np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
    return (
        torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cost),
        scheme.alphabet.gap_id, scheme.gap_open_cost,
        [m for m, _ in shapes], [n for _, n in shapes],
    )


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
    [(40, 100)], [(40, 256)], [(90, 8000)],
    [(30, 127)], [(30, 129)], [(30, 1023)], [(30, 1025)],
    [(20, 2047)], [(20, 2049)], [(20, 8191)], [(20, 8193)],
    [(4, 32_767)], [(4, 32_769)], [(2, 65_535)], [(2, 65_537)],
    [(1, 1)], [(0, 1)], [(1, 0)], [(0, 31)], [(1, 31)], [(33, 31)],
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
    (a level of -1: random)."""
    lv = rng.integers(0, 3, (k + 1, n + 1, 3))
    for lvl, to in enumerate(levels):
        if to >= 0:
            lv[..., lvl] = to
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
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch import align_pairs
    from globalign_tpu_torch.batch import bucket_length
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch import align_pairs
    from globalign_tpu_torch.batch import bucket_length
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch.ops import fill_batch

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
    warp, classes = fill_cuda.ragged_routes(
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
    (11, 511), (300, 512), (9, 513), (45, 1023), (700, 1024), (1, 1024),
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
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch.ops import fill_batch

    rng = np.random.default_rng(83)
    buckets = [_case(rng, "ACGT", sh) for sh in (
        [(30, 1025), (5, 100)], [(40, 2000), (20, 900), (64, 1024)])]
    shared = buckets[0][2:5]
    args = ([b[0] for b in buckets], [b[1] for b in buckets], *shared,
            [b[5] for b in buckets], [b[6] for b in buckets])
    m = [x for b in buckets for x in b[5]]
    n = [x for b in buckets for x in b[6]]
    warp, classes = fill_cuda.ragged_routes(
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


@pytest.mark.parametrize("letters, scheme_kw", [
    ("ACGT", {}),
    ("ACDEFGHIKLMNPQRSTVWY", {"scoring_mat_name": "BLOSUM62"}),
    ("ACGT", {"match_score": 3, "mismatch_score": -4, "gap_open_score": -7,
              "gap_extension_score": -3}),
])
def test_cell_probe_matches_the_row_scan(cuda_device, letters, scheme_kw):
    """The bound's cell probe (DPX form, in registers) computes the fill."""
    from globalign_tpu_torch.utils import peaks

    scheme = resolve_scheme(letters, letters, **scheme_kw)
    cost = torch.from_numpy(
        np.ascontiguousarray(scheme.costing.values, dtype=np.int32)
    )
    peaks.check(cuda_device, cost, scheme.alphabet.gap_id,
                scheme.gap_open_cost, seed=7, pairs=32, rows=40)


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


@pytest.mark.parametrize("rb,width", [(1, 1), (5, 0), (3, 31), (17, 1024),
                                      (64, 13_000), (256, 50_000)])
@pytest.mark.parametrize("letters,scheme_kw", [
    ("ACGT", {}),
    ("ACDEFGHIKLMNPQRSTVWY", {"scoring_mat_name": "BLOSUM62"}),
    ("ACGT", {"match_score": 3, "mismatch_score": -2, "gap_open_score": -5,
              "gap_extension_score": -1}),
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
    from globalign_tpu_torch import align_pairs

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


def _wave_case(rng, m, n, pad=(0, 0), **scheme_kw):
    """Seeded DNA tokens (padded past m / n) and the scheme's uniform costs."""
    from globalign_tpu_torch.ops import fill_wave

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
    (13_000, 40, (3, 0)),
])
@pytest.mark.parametrize("scheme_kw", [
    {},  # the default DNA scheme: the JAX bench's wave arm (bench.py:244-251)
    dict(match_score=3, mismatch_score=-2, gap_open_score=-5,
         gap_extension_score=-1),  # dcost != icost
])
def test_wave_kernel_matches_plain(cuda_device, m, n, pad, scheme_kw):
    """All four captured waves at every row, and the cost: kernel == plain,
    m + n <= 1 included, one launch a call; the cost also equals the
    direct fill."""
    from globalign_tpu_torch.ops import fill_wave

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
    assert int(cost) == int(fill_wave.wave_split_fill_cost(*args))
    direct, _ = fill_cuda.batch_moves(
        args[0][None], args[1][None], cm, scheme.alphabet.gap_id,
        scheme.gap_open_cost, [m], [n], want_moves=False,
    )
    assert int(cost) == int(direct.min())


def test_wave_kernel_rejects_mixed_devices(cuda_device):
    from globalign_tpu_torch.ops import fill_wave

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
    from globalign_tpu_torch.ops import fill_batch

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
    from globalign_tpu_torch.ops import fill_batch

    args = _dual_case(np.random.default_rng(4), "ACGT", 3, 50)
    with pytest.raises(ValueError, match="is on"):
        fill_batch.batch_final3_dual(args[0].to(cuda_device),
                                     args[1].to(cuda_device), *args[2:])


# -- gotoh_tile: one pair's fill over the whole card -------------------------

PROTEIN = "ARNDCQEGHILKMFPSTWYV"


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
    ("ACGT", {}), (PROTEIN, dict(scoring_mat_name="BLOSUM62")),
    ("ACGT", dict(gap_open_cost=0)),
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
    from globalign_tpu_torch.models.gotoh import SPLIT_MIN_ROWS

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
    from globalign_tpu_torch.batch import bucket_length
    from globalign_tpu_torch.ops import packed
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
    from globalign_tpu_torch.ops import packed

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
    from globalign_tpu_torch.ops import linear_tb, packed

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
    from globalign_tpu_torch.batch import bucket_length

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
    from globalign_tpu_torch import align_pairs
    from globalign_tpu_torch import batch as batch_mod
    from globalign_tpu_torch.ops import packed

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

    from globalign_tpu_torch import align_pairs

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

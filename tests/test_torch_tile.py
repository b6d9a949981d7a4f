"""``gotoh_tile``'s schedule and wrapper held against the row scans, on the CPU.

``globalign_tpu_torch.ops.fill_tile``:

  * ``plain_tiled`` — the kernel's schedule executed on the host, tile by
    tile in ticket order from nothing but what the kernel hands over —
    against the port's row scan (``fill_rows.row_fill``) and the JAX row
    scan (``globalign_tpu.ops.fill_rows.row_fill``): final3, every code at
    real cells, the last row and lists of checkpoint rows, at tile edges
    (k H +- 1 rows, k C +- 1 columns), m or n of 0 and 1, under DNA,
    BLOSUM62 and a zero gap-open, with and without injected boundaries;
  * the ticket table: producers hold smaller tickets, every real cell is
    covered once;
  * ``route`` and ``plan`` at the shapes of the crossover sweep;
  * the one-launch checkpoint pass: ``align_blocked(device="cpu")`` against
    the JAX package's blocked traceback, and ``checkpoint_rows`` against
    the pass as it was, a last-rows fill a block.

Tolerance 0: every quantity is an integer or a string.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalign_tpu.ops import fill_rows as jax_rows
from globalign_tpu.ops import linear_tb as jax_ltb
from globalign_tpu_torch import resolve_scheme
from globalign_tpu_torch.ops import fill_cuda, fill_rows, fill_tile, linear_tb
from globalign_tpu_torch.ops.fill_scan import BIG

DNA = "ACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
PAD = 64  # every pair's buffers: one JAX compile a mode
SCHEMES = {
    "dna": (DNA, {}),
    "blosum62": (PROTEIN, dict(scoring_mat_name="BLOSUM62")),
    "zero_open": (DNA, dict(gap_open_cost=0)),
}
TILES = [(4, 8), (8, 4), (5, 3), (16, 16)]  # (rows, columns) a tile


def _scheme(name):
    letters, kw = SCHEMES[name]
    scheme = resolve_scheme(letters, letters, **kw)
    cost = np.ascontiguousarray(scheme.costing.values, np.int32)
    return letters, scheme, cost


def _tokens(rng, scheme, letters, length):
    tok = np.zeros(PAD + 1, np.int32)
    tok[1:] = scheme.alphabet.encode("".join(rng.choice(list(letters), PAD)))
    tok[length + 1 :] = tok[1 : PAD - length + 1]  # padding: other letters
    return tok


def _edge_shapes(height, columns):
    shapes = [
        (height - 1, columns - 1), (height, columns), (height + 1, columns + 1),
        (2 * height + 1, 3 * columns - 1), (3 * height - 1, 2 * columns + 1),
        (0, 7), (7, 0), (0, 0), (1, 1), (1, 2 * columns + 1),
        (3 * height + 1, 1), (PAD, PAD),
    ]
    return [(min(m, PAD), min(n, PAD)) for m, n in shapes]


def _rows_of(m, height):
    return sorted({r for r in (0, 1, height - 1, height, height + 1, m // 2, m)
                   if 0 <= r <= m})


def _jax_fill(ta, tb, cost, gid, go, m, n, row0=None, col0=None):
    return jax_rows.row_fill(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(cost), jnp.int32(gid),
        jnp.int32(go), None if row0 is None else jnp.asarray(row0),
        None if col0 is None else jnp.asarray(col0), m, n,
        want_moves=True, want_planes=True,
    )


@pytest.mark.parametrize("injected", [False, True])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_plain_tiled_equals_the_row_scans(name, tile, injected):
    """The schedule against both row scans at the tile's edges: final3,
    every code at real cells (0 elsewhere), and a list of rows (0, 1, the
    first tile row's edges, m // 2, m) — the last row among them."""
    height, columns = tile
    letters, scheme, cost = _scheme(name)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    rng = np.random.default_rng(height * 100 + columns + 7 * injected)
    for m, n in _edge_shapes(height, columns):
        ta = _tokens(rng, scheme, letters, m)
        tb = _tokens(rng, scheme, letters, n)
        inj, row0, col0 = {}, None, None
        if injected:
            row0 = rng.integers(-5, 60, (3, PAD + 1)).astype(np.int32)
            row0[rng.random((3, PAD + 1)) < 0.2] = BIG
            top = int(rng.integers(-5, 40))
            col0 = fill_cuda._col0(torch.from_numpy(ta), torch.from_numpy(cost),
                                   gid, top).numpy()
            inj = dict(row0=row0[None], col0y_top=np.array([top], np.int32))
        rows = _rows_of(m, height)
        f3, moves, got_rows = fill_tile.plain_tiled(
            ta[None], tb[None], cost, gid, go, [m], [n], height=height,
            columns=columns, rows=[rows], **inj)
        want = _jax_fill(ta, tb, cost, gid, go, m, n, row0, col0)
        port = fill_rows.row_fill(
            torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cost),
            gid, go, m, n, row0=None if row0 is None else torch.from_numpy(row0),
            col0=None if col0 is None else torch.from_numpy(col0),
            want_moves=True, want_planes=True,
        )
        planes = np.asarray(want.planes)
        assert (port.planes.numpy() == planes).all()
        assert (port.moves.numpy() == np.asarray(want.moves)).all()
        assert (f3[0] == np.asarray(want.final3)).all(), (m, n)
        assert (f3[0] == port.final3.numpy()).all(), (m, n)
        real = np.asarray(want.moves)[1 : m + 1, 1 : n + 1]
        assert (moves[0, 1 : m + 1, 1 : n + 1] == real).all(), (m, n)
        outside = moves[0].copy()
        outside[1 : m + 1, 1 : n + 1] = 0
        assert not outside.any(), (m, n)
        for k, r in enumerate(rows):
            assert (got_rows[0, k, :, : n + 1] == planes[:, r, : n + 1]).all(), (
                m, n, r)
            assert (got_rows[0, k, :, n + 1 :] == BIG).all()


@pytest.mark.parametrize("tile", TILES[:3])
def test_plain_tiled_takes_pairs_of_several_shapes(tile):
    """Several pairs in one schedule (B = 2 and 3, interleaved by
    anti-diagonal), injected, against the port's plain fill pair by pair."""
    height, columns = tile
    letters, scheme, cost = _scheme("blosum62")
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    rng = np.random.default_rng(sum(tile))
    for shapes in ([(2 * height + 1, columns + 1), (height - 1, 2 * columns + 3)],
                   [(33, 9), (0, 20), (17, 40)]):
        ta = np.stack([_tokens(rng, scheme, letters, m) for m, _ in shapes])
        tb = np.stack([_tokens(rng, scheme, letters, n) for _, n in shapes])
        mt, nt = [m for m, _ in shapes], [n for _, n in shapes]
        row0 = rng.integers(0, 60, (len(shapes), 3, PAD + 1)).astype(np.int32)
        top = rng.integers(0, 40, len(shapes)).astype(np.int32)
        f3, moves, rows = fill_tile.plain_tiled(
            ta, tb, cost, gid, go, mt, nt, height=height, columns=columns,
            rows=[[m] for m in mt], row0=row0, col0y_top=top)
        want3, want_mv, want_last = fill_cuda._plain(
            torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cost),
            gid, go, torch.tensor(mt), torch.tensor(nt), torch.from_numpy(row0),
            torch.from_numpy(top), True, True)
        assert (f3 == want3.numpy()).all()
        assert (moves == want_mv.numpy()).all()
        assert (rows[:, 0] == want_last.numpy()).all()


# A call's ragged set, as the batch cost fill's wide route takes it: buckets
# at their own padded widths in one arena, mixed aspects, short sides, m or
# n of 0.
RAGGED = [
    [(37, 41), (40, 33), (29, 40)],
    [(9, 70), (0, 65)],  # short and wide, an empty seq_1
    [(66, 12), (61, 0)],  # tall and narrow, an empty seq_2
    [(1, 1)],
]


def _ragged_call(rng, scheme, letters, buckets, quantum=8):
    """``buckets`` packed and tokenized as ``align_pairs`` does it (on the
    CPU): the call, each bucket's (B, M+1) / (B, N+1) views of its arena,
    and each bucket's (m_true, n_true)."""
    from globalign_tpu_torch.ops import packed

    spec = []
    for shapes in buckets:
        seqs = [("".join(rng.choice(list(letters), m)),
                 "".join(rng.choice(list(letters), n))) for m, n in shapes]
        pad_m = -(-max(max(m for m, _ in shapes), 1) // quantum) * quantum
        pad_n = -(-max(max(n for _, n in shapes), 1) // quantum) * quantum
        spec.append(([a for a, _ in seqs], [b for _, b in seqs], pad_m, pad_n))
    call = packed.pack_call(scheme.alphabet, spec, with_render=False)
    call.upload(torch.device("cpu"))
    call.tokenize()
    views = [call.bucket(k) for k in range(len(buckets))]
    lengths = [([m for m, _ in shapes], [n for _, n in shapes])
               for shapes in buckets]
    return call, views, lengths


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", ["dna", "blosum62"])
def test_plain_tiled_reads_a_ragged_arena(name, tile):
    """One schedule over a call's ragged set, each pair's tokens read at its
    own offsets in the arena (``ragged_pairs``), cost only with the last
    row (the wide route's launch): final3 and row m equal the row scan
    pair by pair, and no pair reads a token past its own."""
    height, columns = tile
    letters, scheme, cost = _scheme(name)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    call, views, lengths = _ragged_call(np.random.default_rng(sum(tile)), scheme,
                                        letters, RAGGED)
    _, pairs = fill_tile.ragged_pairs([a for a, _ in views],
                                      [b for _, b in views], [0] * len(views))
    mt = [m for ms, _ in lengths for m in ms]
    nt = [n for _, ns in lengths for n in ns]
    arena = call.arena.numpy()
    f3, moves, rows = fill_tile.plain_tiled(
        arena, arena, cost, gid, go, mt, nt, height=height, columns=columns,
        rows=[[m] for m in mt], want_moves=False, offsets=pairs[:, :2])
    assert moves is None
    p = 0
    for (ta, tb), (ms, ns) in zip(views, lengths):
        want3, _, want_last = fill_cuda._plain(
            ta, tb, torch.from_numpy(cost), gid, go, torch.tensor(ms),
            torch.tensor(ns), None, None, False, True)
        for b, n in enumerate(ns):
            assert (f3[p] == want3[b].numpy()).all(), (p, ms[b], n)
            assert (rows[p, 0, :, : n + 1] == want_last[b, :, : n + 1].numpy()).all()
            assert (rows[p, 0, :, n + 1 :] == BIG).all()
            p += 1


# A ragged moves fill's set: n + 1 at every residue mod 16, m or n of 0.
RAGGED_CODES = [
    [(m, n) for m, n in zip((9, 30, 17, 1, 25, 12, 33, 40), range(15, 23))],
    [(m, n) for m, n in zip((21, 5, 38, 14, 27, 2, 36, 19), range(23, 31))],
    [(0, 17), (11, 0), (1, 1)],
]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_plain_tiled_writes_codes_into_a_ragged_fill(name, tile):
    """The schedule with codes over a ragged moves fill's pairs, each
    pair's codes at its own byte offset, row stride and m + 1 rows (the
    pair table of ``codes_pairs`` over the fill's layout, the pairs placed
    with gaps out of pair order): every byte of each pair's region and
    final3 equal the row scan's ragged buffer (``batch_moves_ragged`` on
    the CPU), and no byte outside the regions is written."""
    height, columns = tile
    letters, scheme, cost = _scheme(name)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    rng = np.random.default_rng(height * 10 + columns)
    call, views, lengths = _ragged_call(rng, scheme, letters, RAGGED_CODES)
    mt = [m for ms, _ in lengths for m in ms]
    nt = [n for _, ns in lengths for n in ns]
    size = fill_cuda.ragged_bytes(np.array(mt), np.array(nt))
    order = rng.permutation(len(mt))
    offsets = np.zeros(len(mt), np.int64)
    offsets[order] = np.cumsum(np.concatenate([[32], size[order][:-1] + 16]))
    want = fill_cuda.batch_moves_ragged(
        [a for a, _ in views], [b for _, b in views], torch.from_numpy(cost),
        gid, go, [m for m, _ in lengths], [n for _, n in lengths],
        offsets=offsets, nbytes=int((offsets + size).max()) + 48)
    assert set(((np.array(nt) + 1) % 16).tolist()) == set(range(16))
    base, pairs = fill_tile.codes_pairs(want.layout)
    shift = (base - call.arena.data_ptr()) // 4
    arena = call.arena.numpy()
    f3, moves, _ = fill_tile.plain_tiled(
        arena, arena, cost, gid, go, mt, nt, height=height, columns=columns,
        offsets=pairs[:, :2] + shift, codes=pairs[:, 3:])
    assert (f3 == want.final3.numpy()[pairs[:, 2]]).all()
    codes = want.codes.numpy()
    written = np.zeros(len(moves), bool)
    for off, ld, rows in pairs[:, 3:].tolist():
        assert (moves[off : off + ld * rows] == codes[off : off + ld * rows]).all()
        written[off : off + ld * rows] = True
    assert (moves[~written] == 255).all() and (~written).any()


def test_wide_route_host_layout():
    """The wide route's tables on the host: each pair's token offsets are
    its rows in the arena (slot + r (width)), its final3 row its row of the
    call's final3, no codes region (cost only), and the one buffer holds the ticket table, the pair
    table (16-byte aligned) and the metadata, in that order."""
    letters, scheme, _ = _scheme("blosum62")
    call, views, lengths = _ragged_call(np.random.default_rng(2), scheme,
                                        letters, RAGGED)
    first_rows = [5, 0, 40, 9]  # each bucket's first row in the call's final3
    base, pairs = fill_tile.ragged_pairs([a for a, _ in views],
                                         [b for _, b in views], first_rows)
    assert base == call.arena.data_ptr()  # bucket 0's seq_1s come first
    assert pairs.dtype == np.int64 and pairs.shape == (8, fill_tile.PAIR_WORDS)
    p = 0
    for k, (slot_a, slot_b, batch, m1, n1) in enumerate(call.slots):
        for r in range(batch):
            assert pairs[p].tolist() == [slot_a + r * m1, slot_b + r * n1,
                                         first_rows[k] + r, 0, 0, 0]
            p += 1
    dims = tuple((m, n) for ms, ns in lengths for m, n in zip(ms, ns))
    order = fill_tile.tile_order(dims, 8, 16)
    meta = fill_tile.metadata(dims, [[m] for m, _ in dims], 8,
                              fill_tile.tile_grid(max(m for m, _ in dims),
                                                  max(n for _, n in dims), 8,
                                                  16)[0])
    buf = fill_tile.host_layout(order, pairs, meta)
    assert buf.dtype == np.int32 and buf.size == order.size + 2 * pairs.size + meta.size
    assert (buf[: order.size] == order.reshape(-1)).all()
    at = order.size  # int32 words: 16-byte rows, so the int64 table is aligned
    assert at % 4 == 0
    assert (buf[at : at + 2 * pairs.size].view(np.int64) == pairs.reshape(-1)).all()
    assert (buf[at + 2 * pairs.size :] == meta).all()


@pytest.mark.parametrize("dims", [
    [(8000, 8000)],
    [(4000, 3900), (1100, 1210), (300, 2000), (0, 5), (17, 0)],
    [(4096, 4096)] * 64,
])
def test_model_and_plan_take_a_list_of_dims(dims):
    """A launch over pairs of several shapes: its path the longest pair's,
    its tiles the sum of every pair's, at every (H, W); the plan the shape
    of least modelled time."""
    sms = 132
    for height, width in fill_tile.SHAPES:
        grids = [fill_tile.tile_grid(max(1, m), max(1, n), height, 32 * width)
                 for m, n in dims]
        got = fill_tile.model(dims, (height, width), False, sms)
        assert got.path_tiles == max(tb + c - 1 for tb, c in grids)
        assert got.tiles == sum(tb * c for tb, c in grids)
        assert got.us == fill_tile.TILE_US[(height, width, False)] * max(
            got.path_tiles, got.tiles / (fill_tile.WARPS * sms))
    shape = fill_tile.plan(dims, False, sms)
    assert fill_tile.model(dims, shape, False, sms).us == min(
        fill_tile.model(dims, s, False, sms).us for s in fill_tile.SHAPES)


def _protein_tail(seed, pairs=1024):
    """The buckets past ``gotoh_batch``'s 1024 columns of a call of the
    protein mix (lengths log-normal, median 300, sigma 0.6, 30-4000; seq_2
    within 5% of seq_1), as ``align_pairs`` buckets them."""
    from globalign_tpu_torch.batch import bucket_length

    rng = np.random.default_rng(seed)
    m = np.clip(np.round(300 * np.exp(0.6 * rng.standard_normal(pairs))), 30, 4000)
    n = np.clip(np.round(m * rng.uniform(0.95, 1.05, pairs)), 30, 4000)
    buckets = {}
    for a, b in zip(m.astype(int).tolist(), n.astype(int).tolist()):
        buckets.setdefault((bucket_length(a), bucket_length(b)), []).append((a, b))
    return [([a for a, _ in v], [b for _, b in v])
            for (_, nb), v in sorted(buckets.items()) if nb > 1024]


@pytest.mark.parametrize("case", [
    "protein_tail", "mesh_shard", "aspect", "one_short_pair", "short_and_long",
])
def test_route_buckets(case):
    """The wide route's rule: a call of the protein mix gives its whole
    tail past 1024 columns to one launch; a mesh shard of 64 x 4096^2 (not
    path-bound) keeps its own route, as does a bucket past 8 columns a row
    and a lone pair under route's 1024^2; inside a launch of several pairs
    a short side rides along."""
    sms = 132
    if case == "protein_tail":
        for seed in (1, 2, 3):
            tail = _protein_tail(seed)
            assert 8 <= sum(len(m) for m, _ in tail) <= 40
            assert fill_tile.route_buckets(tail, sms) == list(range(len(tail)))
        return
    buckets, want = {
        "mesh_shard": ([([4096] * 64, [4096] * 64)], []),
        "aspect": ([([100], [1100]), ([1200], [1300]), ([900, 880], [1050, 1040])],
                   [1, 2]),
        "one_short_pair": ([([600], [1100])], []),
        "short_and_long": ([([600], [1100]), ([1300], [1400])], [0, 1]),
    }[case]
    assert fill_tile.route_buckets(buckets, sms) == want


GENOME = (29_903, 29_903)


@pytest.mark.parametrize("dims,clusters,tail", [
    ([GENOME] * 16, 15, 1), ([GENOME] * 16, 16, 0), ([GENOME] * 15, 15, 0),
    ([GENOME] * 16, 20, 0), ([GENOME] * 16, 13, 3), ([GENOME] * 16, 12, 4),
    ([GENOME] * 16, 11, 0), ([GENOME] * 16, 0, 0),
    ([GENOME] * 15 + [(3000, 29_903)], 15, 0),  # past 8 columns a row
    ([GENOME] * 15 + [(3738, 29_903)], 15, 1),  # within
    ([(3000, 2900)] * 7, 3, 1), ([(3000, 2900)] * 7, 7, 0),
])
def test_route_tail(dims, clusters, tail):
    """A ragged launch class's pairs that one launch with codes takes: its
    count modulo the clusters the card holds at once, where it has more
    pairs than that, if each is within 8 columns a row and the launch is
    path-bound.  A genome call on an H100's 15 clusters gives one; at 16 or
    more clusters, or 15 genomes, none; 3 at 13 and 4 at 12 clusters
    (path-bound at (64, 4) and (128, 4)); 5 at 11 are not path-bound."""
    assert fill_tile.route_tail(dims, clusters, 132) == tail
    if tail:
        assert fill_tile.path_bound(dims[len(dims) - tail :], True, 132)


@pytest.mark.parametrize("height,columns", [(4, 8), (128, 128), (32, 128), (64, 64)])
def test_tile_order_puts_producers_first_and_covers_every_cell_once(height, columns):
    dims = ((0, 5), (3 * height + 1, 2 * columns - 1), (height, 1),
            (5 * height - 3, 7 * columns + 2), (1, 1), (7, 0))
    order = fill_tile.tile_order(dims, height, columns)
    ticket = {tuple(t[:3]): k for k, t in enumerate(order.tolist())}
    assert len(ticket) == len(order)
    diag = order[:, 1] + order[:, 2]
    assert (np.diff(diag) >= 0).all()  # anti-diagonal order
    for p, (m, n) in enumerate(dims):
        cover = np.zeros((m + 1, n + 1), np.int64)
        for (q, b, c), k in ticket.items():
            if q != p:
                continue
            assert b * height < m and c * columns < n  # holds a real cell
            cover[b * height + 1 : (b + 1) * height + 1,
                  c * columns + 1 : (c + 1) * columns + 1] += 1
            for producer in ((p, b - 1, c), (p, b, c - 1)):
                if producer[1] >= 0 and producer[2] >= 0:
                    assert ticket[producer] < k
        assert (cover[1:, 1:] == 1).all() and not cover[0].any()
        assert not cover[:, 0].any()


@pytest.mark.parametrize("cap", [0, 40, 1 << 20])
def test_tile_order_caches_only_tables_within_its_cap(monkeypatch, cap):
    """A table of up to ``CACHED_TILES`` tiles comes from the cache (the
    same read-only array again); a larger one is built for each launch,
    equal to the cached one, and leaves the cache as it was."""
    monkeypatch.setattr(fill_tile, "CACHED_TILES", cap)
    dims = ((9 * 8 + 3, 5 * 16 - 2), (17, 33))  # 10 x 5 + 3 x 3 = 59 tiles
    fill_tile._cached_order.cache_clear()
    first, again = (fill_tile.tile_order(dims, 8, 16) for _ in range(2))
    cached = fill_tile._cached_order.cache_info().currsize
    assert (first is again) is (cap >= 59) and cached == (cap >= 59)
    assert not first.flags.writeable and len(first) == 59
    assert (first == fill_tile._order(dims, 8, 16)).all()


def test_metadata_lays_out_dims_first_rows_and_lists():
    meta = fill_tile.metadata(((9, 4), (20, 3)), [[0, 5, 9], [1, 17, 20]], 8, 3)
    assert meta.tolist() == [
        9, 4, 20, 3,  # (m, n) a pair
        1, 2, 3, 3,  # pair 0: its first entry past row 0, 8, 16, 24
        0, 1, 1, 3,  # pair 1
        0, 5, 9, 1, 17, 20,  # the lists
    ]


def test_route_and_plan_at_the_sweep_shapes():
    """The rule the crossover sweeps chose (PERF.md section 6): gotoh_tile
    for one or two pairs from 256^2 with codes and 1024^2 cost only, up to
    8 columns a row; gotoh_fill for batches, smaller pairs and short, wide
    ones; the plan's (H, W) the one of least modelled time, short tiles for
    short, wide blocks and narrow ones for tall, narrow pairs."""
    sms = 132
    for batch, m, n, moves in ((1, 8000, 8000, True), (1, 4096, 4096, True),
                               (2, 10_000, 20_000, False), (1, 3355, 20_000, True),
                               (1, 20_000, 20_000, False), (2, 1024, 1024, True),
                               (1, 20_000, 512, True), (1, 256, 256, True),
                               (2, 1024, 1024, False), (1, 300, 280, True)):
        assert fill_tile.route(batch, m, n, moves, sms), (batch, m, n)
    for batch, m, n, moves in ((8, 256, 256, True), (8, 8000, 8000, True),
                               (3, 1024, 1024, False), (1, 255, 256, True),
                               (1, 24, 24, True), (64, 4096, 4096, False),
                               (1, 9, 20_000, True), (1, 600, 20_000, False),
                               (2, 300, 20_000, True), (2, 256, 256, False),
                               (1, 1023, 4096, False), (1, 600, 20_000, True)):
        assert not fill_tile.route(batch, m, n, moves, sms), (batch, m, n)
    assert fill_tile.plan([(8000, 8000)], True, sms) == (64, 4)
    assert fill_tile.plan([(3355, 20_000)], True, sms) == (32, 4)
    assert fill_tile.plan([(20_000, 512)], True, sms) == (64, 2)
    assert fill_tile.plan([(20_000, 512)], False, sms) == (128, 4)
    for dims, moves in (([(8000, 8000)], True), ([(10_000, 20_000)] * 2, False)):
        shape = fill_tile.plan(dims, moves, sms)
        best = min(fill_tile.model(dims, s, moves, sms).us
                   for s in fill_tile.SHAPES)
        assert fill_tile.model(dims, shape, moves, sms).us == best


def test_cpu_fills_never_launch():
    """On CPU tensors every route is the row scan: no kernel counter moves."""
    _, scheme, cost = _scheme("dna")
    rng = np.random.default_rng(3)
    ta = torch.from_numpy(_tokens(rng, scheme, DNA, 60))[None]
    tb = torch.from_numpy(_tokens(rng, scheme, DNA, 60))[None]
    before = (fill_tile.gotoh_tile.launches, fill_cuda.batch_moves.launches)
    fill_cuda.batch_moves(ta, tb, torch.from_numpy(cost), scheme.alphabet.gap_id,
                          scheme.gap_open_cost, [60], [60])
    fill_tile.gotoh_tile(ta, tb, torch.from_numpy(cost), scheme.alphabet.gap_id,
                         scheme.gap_open_cost, [60], [60], rows=[[1, 60]])
    assert (fill_tile.gotoh_tile.launches, fill_cuda.batch_moves.launches) == before


def test_gotoh_tile_checks_its_rows():
    _, scheme, cost = _scheme("dna")
    ta = torch.zeros((1, 11), dtype=torch.int32)
    tb = torch.zeros((1, 6), dtype=torch.int32)
    args = (ta, tb, torch.from_numpy(cost), scheme.alphabet.gap_id,
            scheme.gap_open_cost, [10], [5])
    for rows in ([[3, 3]], [[11]], [[-1, 2]], [[]], [[1], [2]]):
        with pytest.raises(ValueError):
            fill_tile.gotoh_tile(*args, rows=rows)


@pytest.mark.parametrize("name", ["dna", "blosum62", "zero_open"])
def test_checkpoint_rows_equal_the_pass_a_block_at_a_time(name):
    """``checkpoint_rows`` (the one-launch pass) against the pass as it was:
    a last-rows fill a block, each seeded from the block above."""
    letters, scheme, cost = _scheme(name)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    rng = np.random.default_rng(len(name))
    m, n = 61, 47
    ta = torch.from_numpy(_tokens(rng, scheme, letters, m)[: m + 1])
    tb = torch.from_numpy(_tokens(rng, scheme, letters, n)[: n + 1])
    cm = torch.from_numpy(cost)
    row0, col0 = linear_tb.default_boundary(ta, tb, cm, gid, go)
    c0_top = col0[2].clone()
    c0_top[0] = go
    for block in (1, 7, 16, m):
        bounds = linear_tb.block_bounds(m, n, block_rows=block)
        rows = [row0[None]]
        for i0, i1 in zip(bounds, bounds[1:]):
            rows.append(fill_cuda.batch_last_rows(
                ta[None, i0 : i1 + 1], tb[None], cm, gid, go, [i1 - i0], [n],
                row0=rows[-1], col0y_top=c0_top[i0 : i0 + 1]))
        got = fill_tile.checkpoint_rows(ta, tb, cm, gid, go, bounds[1:])
        assert torch.equal(got, torch.cat(rows[1:])), block


def _jax_and_port_blocked(scheme, s1, s2, block_rows):
    cm = np.ascontiguousarray(scheme.costing.values, np.int32)
    gid, go = scheme.alphabet.gap_id, scheme.gap_open_cost
    ta = np.zeros(len(s1) + 1, np.int32)
    ta[1:] = scheme.alphabet.encode(s1)
    tb = np.zeros(len(s2) + 1, np.int32)
    tb[1:] = scheme.alphabet.encode(s2)
    want = jax_ltb.align_blocked(
        ta, jnp.asarray(tb), jnp.asarray(cm), jnp.int32(gid), jnp.int32(go),
        s1, s2, block_rows=block_rows, use_pallas=False,
    )
    got = linear_tb.align_blocked(
        torch.from_numpy(ta), torch.from_numpy(tb), torch.from_numpy(cm), gid,
        go, s1, s2, block_rows=block_rows,
    )
    return tuple(want), tuple(got)


@pytest.mark.parametrize("name,block_rows", [
    ("dna", 3), ("dna", 11), ("blosum62", 8), ("zero_open", 40),
])
def test_one_launch_checkpoint_pass_equals_jax_blocked(name, block_rows,
                                                       monkeypatch):
    """``align_blocked(device="cpu")``, whose checkpoint pass is one
    ``checkpoint_rows`` call for every block, against the JAX package's
    blocked traceback: strings, cost and score."""
    from globalign_tpu_torch.ops.transforms import final_cost_to_score

    letters, scheme, _ = _scheme(name)
    rng = np.random.default_rng(block_rows)
    s1 = "".join(rng.choice(list(letters), 53))
    s2 = "".join(rng.choice(list(letters), 41))
    calls = []
    real = linear_tb.checkpoint_rows
    monkeypatch.setattr(linear_tb, "checkpoint_rows",
                        lambda *a: calls.append(a[-1]) or real(*a))
    want, got = _jax_and_port_blocked(scheme, s1, s2, block_rows)
    assert got == want
    assert calls == [linear_tb.block_bounds(53, 41, block_rows=block_rows)[1:]]
    score = [final_cost_to_score(cost=t[3], m=53, n=41,
                                 max_score=scheme.max_score) for t in (want, got)]
    assert score[0] == score[1]

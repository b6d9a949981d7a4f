"""One pair's Gotoh fill over the whole card — ``csrc/gotoh_tile.cu``.

``gotoh_fill`` runs a pair on one cluster of at most 8 SMs; ``gotoh_tile``
cuts a pair (or the few pairs of a launch) into tiles of H rows by 32 W
columns, a warp each, taken by ticket in anti-diagonal order by every SM
of the card, the edges handed on through L2 (the note at the head of the
source).  It computes what ``gotoh_fill``'s moves and last-row modes
compute — final3, the move codes, the last row, with ``row0`` /
``col0y_top`` injection — and one output of its own: any list of rows
of the pair (``rows``), each under the contract of
``fill_cuda.batch_last_rows``, from one launch.  The blocked traceback's
checkpoint pass is that list (:func:`checkpoint_rows`).  Each pair's codes
go to a region of its own (a byte offset, a row stride and a count of
rows in the pair table): a dense (B, M+1, N+1) buffer, or the ragged
buffer of ``fill_cuda.batch_moves_ragged``, where :func:`launch_codes`
fills the pairs that a ``gotoh_fill`` launch class would leave to a lone
last wave of clusters (:func:`route_tail`).

Here live:
  * the tiling: :func:`tile_grid`, the ticket table :func:`tile_order`,
    the launch's metadata (:func:`metadata`), its pair table (each pair's
    token offsets, final3 row and codes region: :func:`ragged_pairs` for
    the pairs of several buckets, :func:`codes_pairs` for those of a
    ragged moves fill) and the one buffer that carries all three to the
    card (:func:`host_layout`);
  * :func:`plan`, the (H, W) of a launch, :func:`route`, the rule by
    which ``fill_cuda`` sends a non-strip fill to this kernel instead of
    ``gotoh_fill``, :func:`route_buckets`, the rule by which the batch
    cost fill gives the buckets past ``gotoh_batch`` to one launch, and
    :func:`route_tail`, the rule by which a ragged moves fill gives a
    launch class's last partial wave of clusters to one launch;
  * the launchers :func:`launch`, :func:`launch_ragged` and
    :func:`launch_codes` (counter ``gotoh_tile.launches``) and the public
    wrapper :func:`gotoh_tile`,
    whose plain version on CPU tensors is the row scan
    (``fill_rows.row_fill``), pair by pair and block by block between the
    requested rows;
  * :func:`plain_tiled`, the executable spec of the kernel's schedule: it
    fills tile by tile in ticket order from nothing but what the kernel
    hands over, and checks that every tile reads its producers' writes.

There is no fallback: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .fill_scan import BIG

WARP = 32
WARPS = 4  # warps a block, one block an SM (the kernel's)
SHAPES = ((128, 4), (64, 4), (64, 2), (32, 4))  # the kernel's (H, W) instances
FLAG_STRIDE = 32  # int32 a flag: one 128-byte line each
EDGE_INTS = 4  # an edge cell in the buffers: (M, Ix, Iy, unused) int32
# int64 a pair: seq_1 and seq_2 offsets, final3 row, and the codes' byte
# offset, row stride and rows
PAIR_WORDS = 6

# A tile's time on an NVIDIA H100 80GB HBM3 at 700 W, in microseconds, by
# (H, W, with codes): a pair one tile column wide, whose 64 tiles run one
# after another, hand-offs included (PERF.md section 6, measured by the
# timing script that lived at chip_smoke.py until commit b226048, "gotoh_tile
# one tile column").  plan() models a launch from them.
TILE_US = {
    (128, 4, False): 24.73, (128, 4, True): 54.63,
    (64, 4, False): 15.79, (64, 4, True): 31.67,
    (64, 2, False): 13.35, (64, 2, True): 25.76,
    (32, 4, False): 11.66, (32, 4, True): 20.72,
}

# route(): gotoh_tile takes a fill of at most ROUTE_MAX_BATCH pairs of at
# least ROUTE_MIN_SIDE rows and columns (with codes; ROUTE_MIN_SIDE_COST
# cost only) and at most ROUTE_MAX_ASPECT columns a row; gotoh_fill the
# rest.
ROUTE_MAX_BATCH = 2
ROUTE_MIN_SIDE = 256
ROUTE_MIN_SIDE_COST = 1024
ROUTE_MAX_ASPECT = 8

# tile_order keeps the tables of up to CACHED_TILES tiles (16 MiB each, so
# its 16 entries hold at most 256 MiB).  A larger one, such as an mpox
# genome's checkpoint pass (2.37 M tiles, 38 MB at (128, 4)), is built for
# its launch alone: indels give every genome a shape of its own.
CACHED_TILES = 1 << 20


def tile_grid(m: int, n: int, height: int, columns: int) -> tuple[int, int]:
    """(TB, C): tile rows over DP rows 1..m, tile columns over 1..n."""
    return -(-m // height), -(-n // columns)


def tile_order(dims: tuple[tuple[int, int], ...], height: int,
               columns: int) -> np.ndarray:
    """The ticket table of a launch over pairs of shapes ``dims`` ((m, n)
    each): (tiles, 4) int32 rows (p, b, c, 0), tile (b, c) of pair p, in
    the order warps take them.

    Tile (b, c) covers rows b*height+1 .. (b+1)*height and columns
    c*columns+1 .. (c+1)*columns of its pair; every tile that holds a
    cell of the pair is in the table, once.  Order: anti-diagonal b + c,
    then the pair, then b, so a tile's producers (b-1, c) and (b, c-1)
    hold smaller tickets.  Built without a sort or a loop over the pairs
    (each tile's ticket is counted directly); the array is read-only
    (cached up to ``CACHED_TILES`` tiles)."""
    tiles = sum(tb * c for tb, c in (tile_grid(m, n, height, columns)
                                     for m, n in dims if m > 0 and n > 0))
    if tiles <= CACHED_TILES:
        return _cached_order(tuple(dims), height, columns)
    return _order(dims, height, columns)


def _order(dims, height: int, columns: int) -> np.ndarray:
    """:func:`tile_order`'s table, built."""
    grids = np.array([tile_grid(m, n, height, columns) if m > 0 and n > 0
                      else (0, 0) for m, n in dims], np.int64).reshape(-1, 2)
    tb, c = grids[:, 0], grids[:, 1]
    diags = int(max((tb + c - 1).max(initial=0), 0))
    d = np.arange(diags)[:, None]
    count = np.maximum(0, np.minimum(d, tb - 1) - np.maximum(0, d - c + 1) + 1)
    count[:, tb == 0] = 0  # tiles (d, p)
    start = (np.cumsum(count.ravel()) - count.ravel()).reshape(count.shape)
    sizes = tb * c  # the first ticket of pair p on diagonal d: start[d, p]
    p = np.repeat(np.arange(len(dims)), sizes)
    k = np.arange(int(sizes.sum())) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    cp = c[p]
    b, cc = k // np.maximum(cp, 1), k % np.maximum(cp, 1)
    dd = b + cc
    ticket = start[dd, p] + b - np.maximum(0, dd - cp + 1)
    out = np.zeros((len(k), 4), np.int32)
    out[ticket, 0], out[ticket, 1], out[ticket, 2] = p, b, cc
    out.flags.writeable = False
    return out


_cached_order = functools.lru_cache(maxsize=16)(_order)


def metadata(dims, rows, height: int, tile_rows: int) -> np.ndarray:
    """The launch's int32 metadata, as the kernel reads it: (m, n) a pair,
    then each pair's index of its first requested row in each tile row
    (``tile_rows`` + 1 entries a pair: rows past b*height), then each
    pair's requested rows (``rows``, a list a pair, all of one length)."""
    first = [np.searchsorted(np.asarray(r, np.int64),
                             np.arange(tile_rows + 1) * height + 1)
             for r in rows] if rows else [np.zeros(tile_rows + 1, np.int64)
                                          for _ in dims]
    parts = [np.asarray(dims, np.int64).reshape(-1), np.concatenate(first)]
    if rows:
        parts.append(np.asarray(rows, np.int64).reshape(-1))
    return np.concatenate(parts).astype(np.int32)


class TileModel(NamedTuple):
    """A launch as :func:`plan` models it: its (H, W), the tiles on its
    critical path, all its tiles, and the modelled microseconds."""

    height: int
    width: int
    path_tiles: int
    tiles: int
    us: float


def model(dims, shape, want_moves: bool, sms: int) -> TileModel:
    """The time of a launch over pairs of shapes ``dims`` ((m, n) each) at
    tile shape ``shape``: its critical path, its longest pair's
    (ceil(m/H) + ceil(n/32W) - 1 tiles), or the tiles of all its pairs
    spread over the card's warps, whichever is longer, at ``TILE_US``."""
    height, width = shape
    grids = [tile_grid(max(1, m), max(1, n), height, WARP * width)
             for m, n in dims]
    path = max(tb + c - 1 for tb, c in grids)
    tiles = sum(tb * c for tb, c in grids)
    us = TILE_US[(height, width, bool(want_moves))] * max(
        path, tiles / (WARPS * sms))
    return TileModel(height, width, path, tiles, us)


def plan(dims, want_moves: bool, sms: int) -> tuple[int, int]:
    """The (H, W) of a launch over pairs of shapes ``dims`` on a card of
    ``sms`` SMs: the shape of ``SHAPES`` with the least :func:`model`
    time (short tiles for short, wide blocks)."""
    return min(SHAPES, key=lambda s: model(dims, s, want_moves, sms).us)[:2]


def route(batch: int, m: int, n: int, want_moves: bool, sms: int) -> bool:
    """Whether ``fill_cuda`` sends a non-strip fill of ``batch`` pairs of up
    to m x n to ``gotoh_tile`` (else ``gotoh_fill``): the single-pair paths'
    fills (align's, the blocked replays, cost()'s 2-pair split) from 256^2
    with codes and 1024^2 cost only, unless short and wide.  In the
    crossover sweeps of PERF.md section 6 (``chip_smoke.py`` of b226048)
    gotoh_tile was faster at B = 1 and 2 from 256^2 with codes and from
    1024^2 cost only (at 256^2 cost only it won one run and lost the
    other), up to 8000^2, at 3355 x 20 000 and at 20 000 x 512.  A short,
    wide fill's tiles form a long path along the columns (ceil(n / 32 W)
    tiles) where gotoh_fill's is about m rows: at 600 x 20 000 gotoh_fill
    won, and past 8 columns a row it keeps them.  Batches keep gotoh_fill,
    and so do pairs below those shapes; the batch cost fill's wide pairs
    have a rule of their own (:func:`route_buckets`)."""
    del sms  # the sweeps found one rule on the H100
    side = ROUTE_MIN_SIDE if want_moves else ROUTE_MIN_SIDE_COST
    return (batch <= ROUTE_MAX_BATCH and min(m, n) >= side
            and n <= ROUTE_MAX_ASPECT * m)


def route_buckets(buckets, sms: int) -> list[int]:
    """The cost-only buckets that one launch fills together: ``buckets``
    lists (m_true, n_true) a bucket (the ones ``gotoh_batch`` leaves,
    ``fill_batch.batch_final3_ragged``'s rest); returns the indices of
    those the launch takes, or [] where each keeps its own route
    (``fill_cuda``'s, by :func:`route`).

    A bucket within :func:`route`'s aspect rule (its n <= 8 m) joins: past
    it gotoh_fill won.  The joined pairs go to one launch when
    :func:`model` finds it path-bound at :func:`plan`'s shape, its tiles
    no more than the card's warps times its longest pair's path, so that
    it takes about its longest pair's time and not the sum of its pairs'.
    A short pair there rides under the longest pair's path, so no least
    side applies; a launch of one pair keeps :func:`route`'s.  Past the
    test (a mesh shard of 64 x 4096^2: 131 072 tiles against 528 warps x
    95) each bucket keeps its own route.  The wide sweep of PERF.md section
    6 (``chip_smoke.py`` at commit b226048) timed both routes."""
    joined = [k for k, (m, n) in enumerate(buckets)
              if max(n) <= ROUTE_MAX_ASPECT * max(m)]
    dims = [d for k in joined for d in zip(*buckets[k])]
    if len(dims) <= 1:
        return joined if dims and route(1, *dims[0], False, sms) else []
    return joined if path_bound(dims, False, sms) else []


def path_bound(dims, want_moves: bool, sms: int) -> bool:
    """Whether :func:`model` finds one launch over pairs of shapes ``dims``
    path-bound at :func:`plan`'s shape: its tiles no more than the card's
    warps times its longest pair's path, so that it takes about that
    pair's time and not the sum of its pairs'."""
    tiles = model(dims, plan(dims, want_moves, sms), want_moves, sms)
    return tiles.tiles <= WARPS * sms * tiles.path_tiles


def route_tail(dims, clusters: int, sms: int) -> int:
    """How many pairs of a ``gotoh_fill`` ragged launch class one launch
    with codes takes instead: ``dims`` the class's (m, n), largest m * n
    first, ``clusters`` the clusters of its launch that the card holds at
    once (``fill_cuda._clusters``).  The class's last ``r`` pairs go, the
    smallest: those its clusters leave to a last, partial wave.

    r is the class's count modulo ``clusters``, where the class has more
    pairs than ``clusters``; none where it has no more (a lone wave) or r
    is 0.  The r pairs go when each is within :func:`route`'s aspect rule
    (its n <= 8 m) and the launch over them is :func:`path_bound`, so that
    it takes about one pair's critical path on the SMs the clusters leave
    and then on all; else the class keeps them.  A call of 16 SARS-CoV-2
    genomes (29 903 nt) on an H100 is a class of 16 whose clusters of 8
    SMs the card holds 15 at once: one genome goes, at (64, 4) a path of
    701 tiles (~22 ms) against a second wave of ~52 ms; 5 or more left
    over are not path-bound (at (128, 4) 5 x 54 756 tiles > 528 warps x
    467)."""
    count = len(dims)
    if clusters < 1 or count <= clusters or not count % clusters:
        return 0
    tail = list(dims)[count - count % clusters :]
    if any(n > ROUTE_MAX_ASPECT * m for m, n in tail):
        return 0
    return len(tail) if path_bound(tail, True, sms) else 0


def _rows_of(rows, m_true) -> list[list[int]] | None:
    """The requested rows a pair, checked: one list a pair, all of one
    length, each strictly increasing in [0, m]."""
    if rows is None:
        return None
    rows = [[int(r) for r in rs] for rs in rows]
    if len(rows) != len(m_true) or len({len(r) for r in rows}) != 1 or not rows[0]:
        raise ValueError("rows must give every pair a list of the same "
                         "non-zero length")
    for rs, m in zip(rows, m_true):
        if rs[0] < 0 or rs[-1] > m or any(b <= a for a, b in zip(rs, rs[1:])):
            raise ValueError(f"rows {rs} must increase strictly in [0, {m}]")
    return rows


def ragged_pairs(tok_a, tok_b, first_rows) -> tuple[int, np.ndarray]:
    """The pair table of a launch over the pairs of several buckets:
    ``tok_a`` / ``tok_b`` list (B_k, M_k+1) / (B_k, N_k+1) contiguous int32
    token tensors on one device, any storage; pair r of bucket k's final3
    goes to row ``first_rows[k] + r``.  Returns (base, pairs): the lowest
    data address among the tokens, and (sum B_k, PAIR_WORDS) int64 rows
    (seq_1 offset, seq_2 offset, final3 row, 0, 0, 0: no codes), the
    offsets in int32 words from base, buckets in order and pairs in their
    bucket's."""
    base = min(t.data_ptr() for t in (*tok_a, *tok_b))
    sizes = np.array([ta.shape[0] for ta in tok_a], np.int64)
    r = np.arange(int(sizes.sum())) - np.repeat(np.cumsum(sizes) - sizes, sizes)

    def per_pair(values):
        return np.repeat(np.asarray(values, np.int64), sizes)

    pairs = np.zeros((len(r), PAIR_WORDS), np.int64)
    for col, tok in enumerate((tok_a, tok_b)):
        pairs[:, col] = (per_pair([(t.data_ptr() - base) // 4 for t in tok])
                         + r * per_pair([t.shape[1] for t in tok]))
    pairs[:, 2] = per_pair(first_rows) + r
    return base, pairs


def codes_pairs(layout: np.ndarray) -> tuple[int, np.ndarray]:
    """The pair table of a launch with codes over pairs of a ragged moves
    fill: ``layout`` their rows of ``fill_cuda.RaggedMoves.layout`` (token
    addresses, m, n, the codes' byte offset and row stride, the final3
    row).  Returns (base, pairs): the lowest token address, and
    (P, PAIR_WORDS) int64 rows (seq_1 offset, seq_2 offset, final3 row,
    codes offset, row stride, m + 1 rows), the token offsets in int32
    words from base, (address - base) / 4."""
    layout = np.asarray(layout, np.int64)
    base = int(layout[:, :2].min())
    pairs = np.empty((len(layout), PAIR_WORDS), np.int64)
    pairs[:, :2] = (layout[:, :2] - base) // 4
    pairs[:, 2] = layout[:, 6]
    pairs[:, 3:5] = layout[:, 4:6]
    pairs[:, 5] = layout[:, 2] + 1
    return base, pairs


def host_layout(order: np.ndarray, pairs: np.ndarray, meta: np.ndarray,
                out: np.ndarray | None = None) -> np.ndarray:
    """A launch's tables as one int32 buffer, for one copy to the card:
    the ticket table (:func:`tile_order`, 16-byte rows), then the pair
    table (int64, so 16-byte aligned), then the metadata (:func:`metadata`).
    Written into ``out`` (pinned memory on the way to a card) if given."""
    sizes = np.cumsum([0, order.size, 2 * pairs.size, meta.size])
    if out is None:
        out = np.empty(sizes[-1], np.int32)
    out[sizes[0] : sizes[1]] = order.reshape(-1)
    out[sizes[1] : sizes[2]] = np.ascontiguousarray(pairs, np.int64).reshape(
        -1).view(np.int32)
    out[sizes[2] : sizes[3]] = meta
    return out


def _run(tok_a: int, tok_b: int, cost_mat, gap_id, gap_open, dims, pairs,
         final3, grid, *, codes=None, rows=None, row0=None, col0y_top=None,
         shape=None):
    """One launch over the pairs ``dims`` ((m, n) each): pair p's tokens at
    ``pairs[p]``'s offsets from the addresses ``tok_a`` / ``tok_b``, its
    final3 into row ``pairs[p, 2]`` of ``final3``, its codes (where
    ``codes``, a uint8 buffer, is given) into the region of ``codes`` that
    ``pairs[p, 3:]`` gives, on ``cost_mat``'s card, on the current stream;
    ``grid`` (M, N) the rows and columns of the rows and edge buffers (no
    pair's m or n past them).  ``rows`` checked lists (:func:`_rows_of`),
    ``shape`` the (H, W) (default :func:`plan`'s).  The tables go in one
    non-blocking copy from pinned memory, so nothing here waits for the
    card.  Returns the rows (B, K, 3, N+1) or None;
    ``gotoh_tile.launches`` counts the launch."""
    from ..utils import cuda_build
    from .fill_cuda import _sms

    lib = cuda_build.load()
    device = cost_mat.device
    batch = len(dims)
    m1, n1 = grid[0] + 1, grid[1] + 1
    if shape is None:
        shape = plan(dims, codes is not None, _sms(device.index))
    height, width = shape
    if (height, width) not in SHAPES:
        raise ValueError(f"no gotoh_tile instance of shape {shape}")
    columns = WARP * width
    tile_rows, tile_cols = tile_grid(m1 - 1, n1 - 1, height, columns)
    order = tile_order(tuple(dims), height, columns)
    meta = metadata(dims, rows, height, tile_rows)
    k = len(rows[0]) if rows else 0
    host = torch.empty(order.size + 2 * pairs.size + meta.size,
                       dtype=torch.int32, pin_memory=True)
    host_layout(order, pairs, meta, out=host.numpy())
    with torch.cuda.device(device):
        tables = host.to(device, non_blocking=True)
        rows_out = (torch.empty((batch, k, 3, n1), dtype=torch.int32,
                                device=device) if rows else None)
        rowbuf = torch.empty((batch, tile_cols * columns + 1, EDGE_INTS),
                             dtype=torch.int32, device=device)
        colbuf = torch.empty((batch, max(tile_rows, 1), height + 1, EDGE_INTS),
                             dtype=torch.int32, device=device)
        flags = torch.zeros(FLAG_STRIDE * (1 + batch * tile_cols),
                            dtype=torch.int32, device=device)

        def ptr(x):
            return None if x is None else x.data_ptr()

        at = tables.data_ptr()
        stream = torch.cuda.current_stream(device).cuda_stream
        gotoh_tile.launches += 1
        err = lib.gotoh_tile_launch(
            tok_a, tok_b, cost_mat.data_ptr(), ptr(row0), ptr(col0y_top),
            at + 4 * (order.size + 2 * pairs.size), at, at + 4 * order.size,
            final3.data_ptr(), ptr(codes), ptr(rows_out), rowbuf.data_ptr(),
            colbuf.data_ptr(), flags.data_ptr(), batch, m1 - 1, n1 - 1,
            cost_mat.shape[0], int(gap_id), int(gap_open), k, len(order),
            height, width, stream,
        )
    if err != 0:
        msg = lib.gotoh_tile_error_string(err).decode()
        raise RuntimeError(f"gotoh_tile launch failed: CUDA error {err} ({msg})")
    return rows_out


def launch(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, *,
           want_moves: bool, rows=None, row0=None, col0y_top=None,
           shape=None):
    """One launch of the kernel on checked inputs (``fill_cuda._check``'s):
    ``(final3 (B, 3), moves (B, M+1, N+1) or None, rows (B, K, 3, N+1) or
    None)`` on the tokens' CUDA device.  ``m_true`` / ``n_true`` host-side
    int32 tensors, ``rows`` checked lists (:func:`_rows_of`), ``shape`` the
    (H, W) (default :func:`plan`'s).  ``gotoh_tile.launches`` counts the
    launches."""
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    p = np.arange(batch, dtype=np.int64)
    pairs = np.zeros((batch, PAIR_WORDS), np.int64)
    pairs[:, 0], pairs[:, 1], pairs[:, 2] = p * m1, p * n1, p
    pairs[:, 3], pairs[:, 4], pairs[:, 5] = p * m1 * n1, n1, m1  # dense codes
    final3 = torch.empty((batch, 3), dtype=torch.int32, device=tok_a.device)
    moves = (torch.empty((batch, m1, n1), dtype=torch.uint8, device=tok_a.device)
             if want_moves else None)
    rows_out = _run(
        tok_a.data_ptr(), tok_b.data_ptr(), cost_mat, gap_id, gap_open,
        list(zip(m_true.tolist(), n_true.tolist())), pairs, final3,
        (m1 - 1, n1 - 1), codes=moves, rows=rows, row0=row0,
        col0y_top=col0y_top, shape=shape,
    )
    return final3, moves, rows_out


def launch_ragged(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
                  final3, first_rows, *, last_rows: bool = False):
    """One cost-only launch over every pair of several buckets (the wide
    route of ``fill_batch.batch_final3_ragged``): ``tok_a`` / ``tok_b``
    list (B_k, M_k+1) / (B_k, N_k+1) checked int32 token tensors on one
    card, each pair read at its own offsets (:func:`ragged_pairs`), so the
    buckets may be views of one arena at their own padded widths;
    ``m_true`` / ``n_true`` their host-side lengths.  Pair r of bucket k's
    final3 goes to row ``first_rows[k] + r`` of ``final3``.  With
    ``last_rows``, each pair's row m_true too: returns each bucket's
    (B_k, 3, N_k+1) rows (views of the launch's rows), else None."""
    base, pairs = ragged_pairs(tok_a, tok_b, first_rows)
    dims = [d for mt, nt in zip(m_true, n_true)
            for d in zip(mt.tolist(), nt.tolist())]
    grid = (max(t.shape[1] for t in tok_a) - 1,
            max(t.shape[1] for t in tok_b) - 1)
    rows_out = _run(base, base, cost_mat, gap_id, gap_open, dims, pairs,
                    final3, grid,
                    rows=[[m] for m, _ in dims] if last_rows else None)
    if not last_rows:
        return None
    lasts, lo = [], 0
    for tb in tok_b:
        lasts.append(rows_out[lo : lo + tb.shape[0], 0, :, : tb.shape[1]])
        lo += tb.shape[0]
    return lasts


def launch_codes(layout, codes, final3, cost_mat, gap_id, gap_open, *,
                 shape=None) -> None:
    """One launch with codes over pairs of a ragged moves fill, into its
    buffers: ``layout`` the pairs' host descriptors (rows of
    ``fill_cuda.RaggedMoves.layout``: token addresses on ``cost_mat``'s
    card, m, n, the codes' byte offset and row stride, the final3 row),
    ``codes`` the fill's uint8 buffer and ``final3`` its (P, 3) int32 rows.
    Each pair's region of ``codes`` comes out as ``batch_moves_ragged``
    writes it, and no byte outside the pairs' regions is written.  On the
    current stream; ``shape`` the (H, W) (default :func:`plan`'s)."""
    base, pairs = codes_pairs(layout)
    dims = list(zip(np.asarray(layout)[:, 2].tolist(),
                    np.asarray(layout)[:, 3].tolist()))
    grid = (max(m for m, _ in dims), max(n for _, n in dims))
    _run(base, base, cost_mat, gap_id, gap_open, dims, pairs, final3, grid,
         codes=codes, shape=shape)


def _plain_rows(tok_a, tok_b, cost_mat, gap_id, gap_open, m, n, rows, row0,
                col0y_top) -> torch.Tensor:
    """One pair's requested rows by the row scan (CPU): (K, 3, n+1), a
    ``row_fill`` a block between consecutive rows, each seeded with the
    row above it and the column-0 Iy there — the blocked checkpoint loop."""
    from .fill_cuda import _col0
    from .fill_rows import row_fill
    from .fill_scan import default_boundary

    go = int(gap_open)
    prev = (default_boundary(tok_a[: m + 1], tok_b[: n + 1], cost_mat, gap_id,
                             go)[0] if row0 is None else row0)
    top, i0 = go if col0y_top is None else int(col0y_top), 0
    out = torch.empty((len(rows), 3, n + 1), dtype=torch.int32)
    for k, r in enumerate(rows):
        if r > i0:
            blk = tok_a[i0 : r + 1]
            prev = row_fill(blk, tok_b[: n + 1], cost_mat, gap_id, go, row0=prev,
                            col0=_col0(blk, cost_mat, gap_id, top),
                            want_moves=False).last3
            top, i0 = int(prev[2, 0]), r
        out[k] = prev
    return out


def gotoh_tile(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    *,
    want_moves: bool = True,
    rows=None,
    row0: torch.Tensor | None = None,
    col0y_top: torch.Tensor | None = None,
    shape: tuple[int, int] | None = None,
):
    """Fill B pairs: ``(final3 (B, 3), moves (B, M+1, N+1) uint8 or None,
    rows (B, K, 3, N+1) int32 or None)``.

    Arguments as ``fill_cuda.batch_moves``'s, and:
        rows: optional lists of rows, one a pair, all of one length K, each
            strictly increasing in [0, m_true[b]]: row r_k of pair b comes
            back at ``rows[b, k]`` under ``batch_last_rows``' contract.
        shape: the tiles' (H, W), one of ``SHAPES`` (default :func:`plan`'s).

    On CUDA tensors one launch of ``gotoh_tile``; on CPU tensors the row
    scan pair by pair (``fill_cuda``'s plain version), the rows block by
    block between them.  ``gotoh_tile.launches`` counts kernel launches.
    """
    from . import fill_cuda

    m_true, n_true = fill_cuda._check(tok_a, tok_b, cost_mat, gap_id, m_true,
                                      n_true, row0, col0y_top)
    rows = _rows_of(rows, m_true.tolist())
    device = tok_a.device
    if device.type == "cuda":
        return launch(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
                      want_moves=want_moves, rows=rows, row0=row0,
                      col0y_top=col0y_top, shape=shape)
    if device.type != "cpu":
        raise ValueError(f"no gotoh_tile route for device {device}")
    final3, moves, _ = fill_cuda._plain(
        tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
        col0y_top, want_moves, False,
    )
    if rows is None:
        return final3, moves, None
    out = torch.full((tok_a.shape[0], len(rows[0]), 3, tok_b.shape[1]), BIG,
                     dtype=torch.int32)
    for b, (m, n) in enumerate(zip(m_true.tolist(), n_true.tolist())):
        out[b, :, :, : n + 1] = _plain_rows(
            tok_a[b], tok_b[b], cost_mat, gap_id, gap_open, m, n, rows[b],
            None if row0 is None else row0[b, :, : n + 1],
            None if col0y_top is None else col0y_top[b],
        )
    return final3, moves, out


gotoh_tile.launches = 0


def checkpoint_rows(tok_a: torch.Tensor, tok_b: torch.Tensor,
                    cost_mat: torch.Tensor, gap_id: int, gap_open: int,
                    rows) -> torch.Tensor:
    """Rows ``rows`` (strictly increasing in [1, m]) of one pair's DP:
    (K, 3, n+1) int32, each under ``batch_last_rows``' contract — the
    blocked traceback's checkpoint pass.  ``tok_a`` / ``tok_b`` (m+1,) /
    (n+1,) int32 tokens.  On CUDA tensors one ``gotoh_tile`` launch
    (cost-only, the rows its only output besides final3); on CPU tensors
    the row scan block by block."""
    m, n = tok_a.shape[0] - 1, tok_b.shape[0] - 1
    _, _, out = gotoh_tile(tok_a[None], tok_b[None], cost_mat, gap_id,
                           gap_open, [m], [n], want_moves=False, rows=[rows])
    return out[0]


def plain_tiled(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, *,
                height: int, columns: int, rows=None, want_moves: bool = True,
                row0=None, col0y_top=None, offsets=None, codes=None):
    """The kernel's schedule, executed on the host: ``(final3 (B, 3),
    moves (B, M+1, N+1) or None, rows (B, K, 3, N+1) or None)`` as numpy
    arrays, for numpy inputs shaped as :func:`gotoh_tile`'s (``rows``
    lists a pair).  With ``offsets`` ((B, 2): the first two columns of a
    pair table, :func:`ragged_pairs`), ``tok_a`` and ``tok_b`` are flat
    buffers and pair p reads its m + 1 and n + 1 tokens from those
    offsets, as the kernel does; M and N are then the largest m and n.
    With ``codes`` ((B, 3): the last three columns of a pair table,
    :func:`codes_pairs`: each pair's byte offset, row stride and rows),
    ``moves`` is a flat uint8 buffer up to the last region's end, each
    pair's codes in its region as the kernel writes them; a byte of no
    region keeps the 255 it starts from.

    What the kernel does, in its order: the writes no tile makes (the code
    bytes of row 0, column 0, the padding and the rows past m of each
    pair's region; row 0 and the pairs with m or n of 0), then the tiles of ``tile_order(dims, height, columns)`` in
    ticket order, each filled from nothing but what the kernel hands over
    — the row buffer (the bottom row of the tile above, and column 0's Iy
    at entry 0), the column buffer (the left tile's right column with Ix
    unclamped, and the corner in slot 0), row 0 / ``row0`` and the
    column-0 seed ``col0y_top`` — cell by cell in the kernel's int32
    forms (Ix serial and unclamped, clamped when stored).  Every buffer
    entry a tile reads must have been written by that tile's producer, the
    tile above or to the left, under a smaller ticket: a schedule that
    breaks this raises AssertionError.  Any tile shape: ``columns`` need
    not be a multiple of 32 here.
    """
    tok_a = np.asarray(tok_a, np.int64)
    tok_b = np.asarray(tok_b, np.int64)
    cost = np.asarray(cost_mat, np.int64)
    gap, go = int(gap_id), int(gap_open)
    dims = tuple((int(m), int(n)) for m, n in zip(m_true, n_true))
    batch = len(dims)
    if offsets is None:
        m1, n1 = tok_a.shape[1], tok_b.shape[1]
        offsets = [(p * m1, p * n1) for p in range(batch)]
        tok_a, tok_b = tok_a.reshape(-1), tok_b.reshape(-1)
    else:
        m1 = max(m for m, _ in dims) + 1
        n1 = max(n for _, n in dims) + 1
    # Each pair's tokens, no more than it holds: a read past them raises.
    seq_a = [tok_a[int(oa) : int(oa) + m + 1] for (oa, _), (m, _) in
             zip(offsets, dims)]
    seq_b = [tok_b[int(ob) : int(ob) + n + 1] for (_, ob), (_, n) in
             zip(offsets, dims)]
    for sa, sb, (m, n) in zip(seq_a, seq_b, dims):
        assert len(sa) == m + 1 and len(sb) == n + 1, "tokens past the buffer"
    k_rows = len(rows[0]) if rows else 0
    final3 = np.zeros((batch, 3), np.int64)
    dense = codes is None
    if dense:  # the regions of a (B, M+1, N+1) buffer
        codes = [(p * m1 * n1, n1, m1) for p in range(batch)]
    codes = np.asarray(codes, np.int64).reshape(batch, 3)
    moves = (np.full(int((codes[:, 0] + codes[:, 1] * codes[:, 2]).max(
        initial=0)), 255, np.uint8) if want_moves else None)
    region = [moves[off : off + ld * nrows].reshape(nrows, ld)
              for off, ld, nrows in codes.tolist()] if want_moves else None
    for (m, n), (_, ld, nrows) in zip(dims, codes.tolist()):
        assert nrows > m and ld > n, "a region too small for its pair"
    rows_out = np.full((batch, k_rows, 3, n1), -1, np.int64) if rows else None

    def row0_at(p, j, dprefix):
        if row0 is not None:
            return tuple(int(x) for x in np.asarray(row0)[p, :, j])
        return (0, 0, 0) if j == 0 else (BIG, go + dprefix, BIG)

    # Before the tickets: what no tile writes.
    for p, (m, n) in enumerate(dims):
        seed = go if col0y_top is None else int(np.asarray(col0y_top)[p])
        if want_moves:
            region[p][0, :] = 0
            region[p][:, 0] = 0
            region[p][1 : m + 1, n + 1 :] = 0
            region[p][m + 1 :, :] = 0
        if rows:
            rows_out[p, :, :, n + 1 :] = BIG
        wants_row0 = bool(rows) and rows[p][0] == 0
        if m == 0 or wants_row0:
            d = 0
            for j in range(n + 1):
                d += int(cost[gap, seq_b[p][j]]) if j else 0
                v = row0_at(p, j, d)
                if wants_row0:
                    rows_out[p, 0, :, j] = v
                if m == 0 and j == n:
                    final3[p] = v
        if n == 0 and m > 0:
            y = seed
            for i in range(1, m + 1):
                y += int(cost[seq_a[p][i], gap])
                if i == m:
                    final3[p] = (BIG, BIG, y)
                if rows and i in rows[p]:
                    rows_out[p, rows[p].index(i), :, 0] = (BIG, BIG, y)

    tile_rows, tile_cols = tile_grid(m1 - 1, n1 - 1, height, columns)
    # Buffer entries with the (ticket, tile) that wrote them.
    rowbuf = [[None] * (tile_cols * columns + 1) for _ in range(batch)]
    colbuf = [[[None] * (height + 1) for _ in range(tile_rows)]
              for _ in range(batch)]

    def take(entry, t, producer):
        assert entry is not None, "a tile read an entry no tile wrote"
        (wt, wtile), value = entry
        assert wtile == producer and wt < t, (
            f"ticket {t} read {wtile}'s write (ticket {wt}), not {producer}'s")
        return value

    for t, (p, b, c, _) in enumerate(tile_order(dims, height, columns).tolist()):
        m, n = dims[p]
        r0, c0 = b * height, c * columns
        hh, ncols = min(height, m - r0), min(columns, n - c0)
        me = (b, c)
        # The left edge: (M, Ix unclamped, Iy) a row, the corner first.
        if c == 0:
            y = (take(rowbuf[p][0], t, (b - 1, 0))[2] if b > 0 else
                 go if col0y_top is None else int(np.asarray(col0y_top)[p]))
            corner = ((BIG, BIG, y) if b > 0 else
                      row0_at(p, 0, 0))
            edge = [corner]
            for i in range(r0 + 1, r0 + hh + 1):
                y += int(cost[seq_a[p][i], gap])
                edge.append((BIG, BIG, y))
        else:
            edge = [take(colbuf[p][b][k], t, (b, c - 1)) for k in range(hh + 1)]
        # The top edge: row r0 at columns c0+1 .. c0+ncols.
        if b > 0:
            top = [take(rowbuf[p][j], t, (b - 1, c))
                   for j in range(c0 + 1, c0 + ncols + 1)]
        else:
            x = go if c == 0 else edge[0][1]  # go + D[c0]
            top = []
            for j in range(c0 + 1, c0 + ncols + 1):
                x += int(cost[gap, seq_b[p][j]])
                top.append(row0_at(p, j, x - go))
        right = [top[-1]]  # the corner of the tile to the right
        for rr in range(hh):
            i = r0 + 1 + rr
            a = seq_a[p][i]
            ic = int(cost[a, gap])
            l_m, l_xu, l_y = edge[rr + 1]
            d_m, d_x, d_y = edge[rr]
            d_x = min(d_x, BIG)
            xu, h_m, h_x, h_y = l_xu, l_m, min(l_xu, BIG), l_y
            new = []
            for q in range(ncols):
                j = c0 + 1 + q
                mp, xp, yp = top[q]
                d = int(cost[gap, seq_b[p][j]])
                best = min(d_m, d_x, d_y)
                mc = min(best + int(cost[a, seq_b[p][j]]), BIG)
                vy = min(min(mp, xp) + go, yp)
                yc = min(vy + ic, BIG)
                xu = min(xu + d, min(h_m, h_y) + go + d)
                xc = min(xu, BIG)
                if want_moves:
                    code_m = 0 if d_m == best else 1 if d_x == best else 2
                    code_y = 0 if mp + go == vy else 1 if xp + go == vy else 2
                    code_x = 0 if xc == h_m + go + d else 1 if xc == h_x + d else 2
                    region[p][i, j] = code_m | code_x << 2 | code_y << 4
                d_m, d_x, d_y = mp, xp, yp
                new.append((mc, xc, yc))
                h_m, h_x, h_y = mc, xc, yc
            top = new
            right.append((new[-1][0], xu, new[-1][2]))
            if rows and i in rows[p]:
                k = rows[p].index(i)
                rows_out[p, k, :, c0 + 1 : c0 + ncols + 1] = np.array(new).T
                if c == 0:
                    rows_out[p, k, :, 0] = (BIG, BIG, l_y)
            if i == m and c0 < n <= c0 + ncols:
                final3[p] = new[n - c0 - 1]
        for q, v in enumerate(top):
            rowbuf[p][c0 + 1 + q] = ((t, me), v)
        if c == 0:
            rowbuf[p][0] = ((t, me), edge[hh])
        if n > c0 + columns:  # a tile to the right
            colbuf[p][b][: hh + 1] = [((t, me), v) for v in right]
    if want_moves and dense:
        moves = moves.reshape(batch, m1, n1)
    return final3, moves, rows_out

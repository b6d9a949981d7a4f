"""Batched Gotoh fills — the CUDA kernel and its plain version.

Four wrappers of one kernel, ``csrc/gotoh_fill.cu`` (a pair's columns
over a cluster of blocks, the strip state in registers; see the note at
the head of that file, and :func:`plan` for the launch):

  * ``batch_moves`` — final3 and row-major move codes for B pairs, the
    counterpart of ``globalign_tpu/ops/fill_pallas.py:batch_moves`` and,
    with ``row0`` / ``col0y_top``, of the injected ``lanes_batch_moves`` /
    ``stacked_fill_with_moves`` that the blocked traceback replays with;
  * ``batch_last_rows`` — the full last DP row of B pairs, the counterpart
    of ``lanes_batch_last_rows`` (optionally injected),
    ``stacked_fill_last_rows`` and ``row_fill_last_rows``: the blocked
    traceback's checkpoint fill and the cost split's 2-pair fill;
  * ``strip_fill_block`` — one column strip's block of rows, its left
    boundary a neighbour strip's right edge: the row m_true and the strip's
    own right edge, the counterpart of ``fill_pallas.strip_fill_block``
    (TPU kernel ``_make_strip_kernel``), the block fill of the
    sequence-parallel pipeline (``parallel.seqpar``);
  * ``batch_moves_ragged`` — final3 and move codes of the pairs of several
    buckets, each pair's codes packed into one buffer in 16-byte-aligned
    rows through a per-pair descriptor (:func:`ragged_offsets`): the moves
    fills of a traceback ``align_pairs`` call, which the JAX package walks
    in one device program (``globalign_tpu/batch.py:_lanes_walk_fills``,
    ``_mega_walk_flush``); ``ops.linear_tb.walk_ragged`` walks them.  Its
    pairs of at most 1024 columns go to a second kernel,
    ``csrc/gotoh_batch_moves.cu`` (a warp a pair, one launch a width
    class, ``fill_batch.batch_moves_warp``), the rest to ``gotoh_fill``'s
    ragged mode, one launch a launch class (:func:`ragged_routes`) — but
    for the pairs of a class that its clusters, as many as the card holds
    at once (:func:`_clusters`), would leave to a lone last wave: those go
    to one ``gotoh_tile`` launch into the same buffer, on a side stream
    beside the class's launch (``fill_tile.route_tail``: a call of 16
    genomes fills 15 on ``gotoh_fill`` and the 16th on every SM the 15
    clusters leave).

On CUDA tensors each launches the kernel; on CPU tensors each runs the
plain version, the row scan of ``ops.fill_rows``, pair by pair.  There is
no other route: a CUDA tensor that the kernel cannot take raises.  One
exception by rule: a non-strip fill of one or two large pairs, which a
cluster of 8 SMs a pair serves poorly, goes to
``csrc/gotoh_tile.cu`` (tiles over every SM; ``ops.fill_tile``) where
``fill_tile.route`` says so — the same outputs, counted on
``fill_tile.gotoh_tile.launches``; each wrapper's own counter counts its
``gotoh_fill`` launches.

Unlike the TPU path there is no skewed layout and no host unskew
(``fill_lanes.lanes_moves_to_row``): the kernel writes ``moves[b, i, j]``
directly.  Codes are defined at real cells 1 <= i <= m_true[b],
1 <= j <= n_true[b]; every other byte is 0 on both routes.  Last rows are
defined at columns 0..n_true[b]; the columns past it are BIG on both.

Boundary injection: ``row0`` (B, 3, N+1) int32 replaces row 0 (its column
0 is the diagonal seed of cell (1, 1)) and ``col0y_top`` (B,) int32
replaces the ``gap_open`` that starts the column-0 Iy sum, so
Iy(i, 0) = col0y_top + icost(a_1) + ... + icost(a_i).  Row-1 codes then
point at the injected row's argmins.  Either may be given alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.spans import span
from . import fill_tile
from .fill_rows import row_fill
from .fill_scan import BIG

WIDTHS = (4, 8, 16, 32)  # the kernel's instances: columns a lane (W)
MOVES_WIDTHS = (4, 8, 16)  # with codes: 32 staged rows of 32 W bytes a warp
MAX_WARPS = 8  # warps a block (the kernel's __launch_bounds__)
MAX_BANDS = 8  # blocks a pair: the portable cluster size
DESC_WORDS = 8  # int64 words of a ragged pair descriptor (csrc/gotoh_fill.cu)
ALIGN = 16  # bytes: a ragged fill's code offsets and row strides


class FillPlan(NamedTuple):
    """A launch of ``gotoh_fill``: ``width`` columns a lane, ``warps``
    warps a block (a band of warps * 32 * width columns), ``bands`` blocks
    a pair (one cluster), and the ``passes`` the widest pair takes over its
    columns."""

    width: int
    warps: int
    bands: int
    passes: int

    @property
    def band_columns(self) -> int:
        return self.warps * 32 * self.width


def plan(batch: int, n_cols: int, want_moves: bool, sms: int) -> FillPlan:
    """The launch for ``batch`` pairs of up to ``n_cols`` columns on a card
    of ``sms`` SMs.

    W is the narrowest instance whose chain of warps (one a 32 W columns)
    fits one cluster of MAX_BANDS blocks of MAX_WARPS warps — or one block,
    once the batch fills the card: narrow strips keep the serial Ix chain of
    a wave short.  The bands are as many as fill the card (batch * bands >=
    sms) without a band of no warp, and no fewer than the chain needs, so a
    batch that fills the card gets one block a pair where the widest
    instance allows.  Wider pairs than a cluster holds take several
    passes."""
    widths = MOVES_WIDTHS if want_moves else WIDTHS
    n = max(1, n_cols)
    fill = -(-sms // max(1, batch))  # bands a pair that fill the card
    for width in widths:
        if -(-n // (32 * width)) <= MAX_WARPS * (MAX_BANDS if fill > 1 else 1):
            break
    chain = -(-n // (32 * width))  # warps a pair needs
    bands = min(MAX_BANDS, chain, max(-(-chain // MAX_WARPS), fill))
    warps = min(MAX_WARPS, -(-chain // bands))
    bands = min(MAX_BANDS, -(-chain // warps))
    passes = -(-n // (bands * warps * 32 * width))
    return FillPlan(width, warps, bands, passes)


@functools.cache
def _sms(index: int) -> int:
    """The SM count of card ``index`` (a query is too slow for every launch)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lengths(lengths, batch: int, cap: int, name: str) -> torch.Tensor:
    out = torch.as_tensor(lengths, dtype=torch.int32)
    if out.device.type != "cpu":
        raise ValueError(f"{name} must be host-side (CPU tensor, list or array)")
    if out.shape != (batch,):
        raise ValueError(f"{name} must have shape ({batch},), got {tuple(out.shape)}")
    if bool((out < 0).any()) or bool((out > cap).any()):
        raise ValueError(f"{name} must lie in [0, {cap}], got {out.tolist()}")
    return out


def _check(tok_a, tok_b, cost_mat, gap_id, m_true, n_true, row0, col0y_top,
           col0=None):
    """Validate a fill's arguments; returns the host-side lengths."""
    if tok_a.dim() != 2 or tok_b.dim() != 2 or tok_a.shape[0] != tok_b.shape[0]:
        raise ValueError("tok_a / tok_b must be (B, M+1) / (B, N+1)")
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    if batch < 1 or m1 < 1 or n1 < 1:
        raise ValueError("empty token buffers")
    num = cost_mat.shape[0]
    if cost_mat.dim() != 2 or cost_mat.shape[1] != num:
        raise ValueError("cost_mat must be square (A, A)")
    if not 0 <= int(gap_id) < num:
        raise ValueError(f"gap_id {gap_id} outside the alphabet of {num}")
    tensors = [("tok_a", tok_a), ("tok_b", tok_b), ("cost_mat", cost_mat)]
    if row0 is not None:
        if tuple(row0.shape) != (batch, 3, n1):
            raise ValueError(
                f"row0 must be ({batch}, 3, {n1}), got {tuple(row0.shape)}"
            )
        tensors.append(("row0", row0))
    if col0y_top is not None:
        if tuple(col0y_top.shape) != (batch,):
            raise ValueError(
                f"col0y_top must be ({batch},), got {tuple(col0y_top.shape)}"
            )
        tensors.append(("col0y_top", col0y_top))
    if col0 is not None:
        if tuple(col0.shape) != (batch, 3, m1):
            raise ValueError(
                f"col0 must be ({batch}, 3, {m1}), got {tuple(col0.shape)}"
            )
        tensors.append(("col0", col0))
    for name, x in tensors:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != tok_a.device:
            raise ValueError(f"{name} is on {x.device}, tok_a on {tok_a.device}")
    return (
        _lengths(m_true, batch, m1 - 1, "m_true"),
        _lengths(n_true, batch, n1 - 1, "n_true"),
    )


def _check_buckets(tok_a, tok_b, cost_mat, gap_id, m_true, n_true):
    """Validate the buckets of a ragged fill (sequences of (B_k, M_k+1) /
    (B_k, N_k+1) tokens and (B_k,) lengths, on one device); returns the
    device and each bucket's host-side (m_true, n_true)."""
    if not tok_a or len(tok_b) != len(tok_a) or len(m_true) != len(tok_a) or (
        len(n_true) != len(tok_a)
    ):
        raise ValueError("tok_a, tok_b, m_true and n_true must list the same "
                         "buckets, at least one")
    device = tok_a[0].device
    lengths = []
    for ta, tb, mt, nt in zip(tok_a, tok_b, m_true, n_true):
        if ta.device != device:
            raise ValueError(f"a bucket is on {ta.device}, the first on {device}")
        lengths.append(_check(ta, tb, cost_mat, gap_id, mt, nt, None, None))
    return device, lengths


def _col0(tok_a, cost_mat, gap_id, top: int) -> torch.Tensor:
    """(3, m+1) column-0 boundary whose Iy lane starts its sum at ``top``
    (the other lanes and entry 0 are never read by ``row_fill``)."""
    steps = cost_mat[tok_a, gap_id].clone()
    steps[0] = 0
    iy = top + torch.cumsum(steps, 0, dtype=torch.int32)
    big = torch.full_like(iy, BIG)
    return torch.stack([big, big, iy])


def _plain(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
           col0y_top, want_moves, want_last):
    """The kernel's plain version: ``row_fill`` pair by pair (CPU)."""
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    final3 = torch.empty((batch, 3), dtype=torch.int32)
    moves = torch.zeros((batch, m1, n1), dtype=torch.uint8) if want_moves else None
    last = torch.full((batch, 3, n1), BIG, dtype=torch.int32) if want_last else None
    for b in range(batch):
        m, n = int(m_true[b]), int(n_true[b])
        ta, tb = tok_a[b, : m + 1], tok_b[b, : n + 1]
        res = row_fill(
            ta, tb, cost_mat, gap_id, gap_open,
            row0=None if row0 is None else row0[b, :, : n + 1],
            col0=(
                None if col0y_top is None
                else _col0(ta, cost_mat, gap_id, int(col0y_top[b]))
            ),
            want_moves=want_moves,
        )
        final3[b] = res.final3
        if want_moves:
            moves[b, 1 : m + 1, 1 : n + 1] = res.moves[1:, 1:]
        if want_last:
            last[b, :, : n + 1] = res.last3
    return final3, moves, last


def _plain_strip(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
                 row0, col0):
    """The strip mode's plain version: ``row_fill``'s strip modes pair by
    pair (CPU), returning ``(fin, edge)`` as ``strip_fill_block`` does."""
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    fin = torch.full((batch, 3, n1), BIG, dtype=torch.int32)
    edge = torch.full((batch, 3, m1), BIG, dtype=torch.int32)
    for b in range(batch):
        m, n = int(m_true[b]), int(n_true[b])
        res = row_fill(
            tok_a[b], tok_b[b, : n + 1], cost_mat, gap_id, gap_open, m, n,
            row0=row0[b, :, : n + 1], col0=col0[b], want_moves=False,
            col0_full=True, want_edge=True, want_fin_row=True,
        )
        fin[b, :, : n + 1] = res.fin_row
        edge[b, :, 0] = row0[b, :, n]
        edge[b, :, 1 : m + 1] = res.edge[:m].T
    return fin, edge


def _fill(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
          col0y_top, want_moves, want_last, counter, col0=None):
    """Route one fill: the plain version on CPU tensors; on CUDA tensors
    ``gotoh_tile`` where ``fill_tile.route`` sends a non-strip fill (a few
    large pairs), else ``gotoh_fill`` (:func:`_launch`).
    Returns ``(final3, moves, last, edge)``; ``col0`` selects strip mode
    (``edge`` is None otherwise)."""
    m_true, n_true = _check(
        tok_a, tok_b, cost_mat, gap_id, m_true, n_true, row0, col0y_top, col0
    )
    device = tok_a.device
    if device.type == "cpu":
        if col0 is not None:
            fin, edge = _plain_strip(
                tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
                col0,
            )
            final3 = torch.stack(
                [fin[b, :, n] for b, n in enumerate(n_true.tolist())]
            )
            return final3, None, fin, edge
        return (*_plain(
            tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
            col0y_top, want_moves, want_last,
        ), None)
    if device.type != "cuda":
        raise ValueError(f"no gotoh_fill route for device {device}")
    if col0 is None and fill_tile.route(
        tok_a.shape[0], int(m_true.max()), int(n_true.max()), want_moves,
        _sms(device.index),
    ):
        final3, moves, rows = fill_tile.launch(
            tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
            want_moves=want_moves,
            rows=[[m] for m in m_true.tolist()] if want_last else None,
            row0=row0, col0y_top=col0y_top,
        )
        return final3, moves, None if rows is None else rows[:, 0], None
    return _launch(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true,
                   row0, col0y_top, want_moves, want_last, counter, col0)


def _launch(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
            col0y_top, want_moves, want_last, counter, col0):
    """One ``gotoh_fill`` launch on checked CUDA inputs (``_fill``'s
    arguments, host-side lengths); ``counter.launches`` counts it."""
    from ..utils import cuda_build

    device = tok_a.device
    lib = cuda_build.load()
    batch, m1 = tok_a.shape
    n1 = tok_b.shape[1]
    lp = plan(batch, n1 - 1, want_moves, _sms(device.index))
    final3 = torch.empty((batch, 3), dtype=torch.int32, device=device)
    moves = (
        torch.empty((batch, m1, n1), dtype=torch.uint8, device=device)
        if want_moves
        else None
    )
    last = (
        torch.empty((batch, 3, n1), dtype=torch.int32, device=device)
        if want_last
        else None
    )
    edge = (
        torch.empty((batch, 3, m1), dtype=torch.int32, device=device)
        if col0 is not None
        else None
    )
    pass_edge = (  # (B, 2, M+1) int4: a pass's right edge for the next
        torch.empty((batch, 2, m1, 4), dtype=torch.int32, device=device)
        if lp.passes > 1
        else None
    )
    m_dev = m_true.pin_memory().to(device, non_blocking=True)
    n_dev = n_true.pin_memory().to(device, non_blocking=True)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        counter.launches += 1
        err = lib.gotoh_fill_launch(
            tok_a.data_ptr(), tok_b.data_ptr(), cost_mat.data_ptr(),
            m_dev.data_ptr(), n_dev.data_ptr(), ptr(row0), ptr(col0y_top),
            ptr(col0), final3.data_ptr(), ptr(moves), ptr(last), ptr(edge),
            ptr(pass_edge),
            batch, m1 - 1, n1 - 1, cost_mat.shape[0], int(gap_id),
            int(gap_open), lp.width, lp.warps, lp.bands, stream,
        )
    if err != 0:
        msg = lib.gotoh_fill_error_string(err).decode()
        raise RuntimeError(f"gotoh_fill launch failed: CUDA error {err} ({msg})")
    return final3, moves, last, edge


def batch_moves(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    *,
    want_moves: bool = True,
    row0: torch.Tensor | None = None,
    col0y_top: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fill B pairs: ``(final3 (B, 3) int32, moves (B, M+1, N+1) uint8)``.

    Args:
        tok_a / tok_b: (B, M+1) / (B, N+1) int32 contiguous 1-origin tokens
            (column 0 unused), on the CPU or on a CUDA device.
        cost_mat: (A, A) int32 contiguous costing matrix on the same device.
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: (B,) true lengths, host-side.
        want_moves: False skips the codes (``moves`` is None) — the direct
            cost-only fill.
        row0 / col0y_top: optional boundary injection (module docstring),
            on the tokens' device.

    ``batch_moves.launches`` counts kernel launches.
    """
    final3, moves, _, _ = _fill(
        tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
        col0y_top, want_moves, False, batch_moves,
    )
    return final3, moves


def batch_last_rows(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    row0: torch.Tensor | None = None,
    col0y_top: torch.Tensor | None = None,
) -> torch.Tensor:
    """Row ``m_true[b]`` of B pairs' DP: (B, 3, N+1) int32 (M, Ix, Iy).

    Column 0 is (BIG, BIG, Iy(m, 0)) — or row 0's column 0 when
    m_true[b] = 0 — and columns past n_true[b] are BIG: the contract of
    ``ops.fill_rows.RowFillResult.last3`` per pair.  Arguments as in
    :func:`batch_moves`; no move codes are written.

    ``batch_last_rows.launches`` counts kernel launches.
    """
    _, _, last, _ = _fill(
        tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0,
        col0y_top, False, True, batch_last_rows,
    )
    return last


def strip_fill_block(
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    row0: torch.Tensor,
    col0: torch.Tensor,
    m_true,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of rows of B column strips: ``(fin (B, 3, N+1), edge (B, 3,
    M+1))`` int32.

    Args:
        tok_a / tok_b: (B, M+1) block tokens / (B, N+1) strip tokens, int32
            contiguous, 1-origin (entry 0 unused).
        row0: (B, 3, N+1) the block's top row (the row above it, or the
            strip's share of the matrix's row 0); its column 0 is the
            diagonal seed of cell (1, 1).
        col0: (B, 3, M+1) the block's left boundary: cell (i, 0) for
            1 <= i <= m_true, all three lanes — the right edge of the strip
            to the left, or (BIG, BIG, Iy) at the matrix edge.  Its Ix
            continues into the row without a fresh gap-open.
        m_true: (B,) host-side rows of the block (its tokens past them are
            padding); every strip is N columns wide.

    ``fin[b]`` is row m_true[b] (column 0 from ``col0``; row0 itself when
    m_true[b] = 0): the TPU kernel's ``fin``.  ``edge[b, :, 0]`` is row0
    at column N, ``edge[b, :, i]`` the lanes of cell (i, N) for
    1 <= i <= m_true[b], and the rows past m_true[b] are BIG — the next
    strip's ``col0`` for the same block.  The TPU kernel's ``last`` (the
    state after all M rows) is not emitted: it differs from ``fin`` only on
    a partial block, which is the pipeline's final one, and no block
    follows it.

    On CUDA tensors one launch of ``gotoh_fill``'s strip mode; on CPU
    tensors the plain version, ``row_fill(col0_full=True, want_edge=True,
    want_fin_row=True)`` pair by pair.  ``strip_fill_block.launches``
    counts kernel launches.
    """
    if row0 is None or col0 is None:
        raise ValueError("strip_fill_block needs row0 and col0")
    n_true = [tok_b.shape[1] - 1] * tok_b.shape[0]
    _, _, fin, edge = _fill(
        tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true, row0, None,
        False, True, strip_fill_block, col0=col0,
    )
    return fin, edge


batch_moves.launches = 0
batch_last_rows.launches = 0
strip_fill_block.launches = 0


class RaggedMoves(NamedTuple):
    """What :func:`batch_moves_ragged` gives, for ``linear_tb.walk_ragged``.

    ``final3`` (P, 3) int32: pair k of the call at row k.  ``codes``
    (nbytes,) uint8: pair k's codes, (m_k + 1) rows of
    ``ragged_stride(n_k)`` bytes at byte ``layout[i, 4]`` (a multiple of
    ``ALIGN``) for the descriptor i whose final3 row ``layout[i, 6]`` is k,
    row-major, real cells as in :func:`batch_moves` and every other byte of
    those rows 0.  ``desc``
    (P, DESC_WORDS) int64 on the codes' device and ``layout``, the same
    descriptors on the host, in launch order: seq_1 and seq_2 token
    addresses, m, n, the codes' byte offset, their row stride, the final3
    row, a pad."""

    final3: torch.Tensor
    codes: torch.Tensor
    desc: torch.Tensor
    layout: np.ndarray


def ragged_stride(n_true):
    """The row stride of a ragged fill's codes (an int, or an int64 array
    of them): n + 1 bytes rounded up to ``ALIGN``, so that every row of a
    pair placed at a multiple of ``ALIGN`` starts aligned and
    ``gotoh_batch_moves`` stores it in aligned units."""
    return (n_true + ALIGN) // ALIGN * ALIGN


def ragged_bytes(m_true, n_true):
    """Bytes of a pair's codes in a ragged fill (ints, or int64 arrays):
    (m + 1) rows of :func:`ragged_stride` bytes — the size ``align_pairs``
    budgets its traceback segments by."""
    return (m_true + 1) * ragged_stride(n_true)


def ragged_offsets(m_true, n_true) -> np.ndarray:
    """(P + 1,) int64: the byte offsets of P pairs' codes packed in order,
    pair k's :func:`ragged_bytes` from entry k (each a multiple of
    ``ALIGN``), and the total last.  In int64 end to end: the JAX package's
    mega-walk blob offsets are int32 and wrap past 2^31 bytes
    (globalign_tpu/batch.py:944-948)."""
    sizes = ragged_bytes(np.asarray(m_true, np.int64), np.asarray(n_true, np.int64))
    return np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes, dtype=np.int64)])


def ragged_classes(m_true, n_true, sms: int) -> list[tuple[FillPlan, np.ndarray]]:
    """The launches of a ragged moves fill on a card of ``sms`` SMs: a
    launch a class, as ``(plan, pair indices)``, the indices longest (m * n)
    first.

    A launch has one cluster shape, so pairs are grouped by the (width,
    bands, passes) that :func:`plan` gives each pair's columns at the whole
    call's count of pairs; each class then launches with the plan of its
    own count and widest pair.  Pairs of one width class share a launch:
    the 1024-pair serving chunk (819-1024 columns) is one class of one
    block a pair, where a bucket of ~21 pairs spread each pair over a
    cluster.  A class of more pairs than the card holds clusters of its
    launch at once fills in waves; :func:`ragged_routes` gives the pairs
    of a last, partial wave to ``gotoh_tile`` where
    ``fill_tile.route_tail`` says so."""
    m = np.asarray(m_true, np.int64)
    n = np.asarray(n_true, np.int64)
    keys = {}
    for cols in np.unique(n).tolist():
        lp = plan(len(n), cols, True, sms)
        keys[cols] = (lp.width, lp.bands, lp.passes)
    classes = {}
    for k, cols in enumerate(n.tolist()):
        classes.setdefault(keys[cols], []).append(k)
    out = []
    for key in sorted(classes, reverse=True):
        idx = np.asarray(classes[key], np.int64)
        idx = idx[np.argsort(-(m[idx] * n[idx]), kind="stable")]
        out.append((plan(len(idx), int(n[idx].max()), True, sms), idx))
    return out


def ragged_routes(m_true, n_true, alphabet: int, sms: int, clusters=None):
    """The launches of a ragged moves fill with an (A, A) table on a card of
    ``sms`` SMs: ``(warp, fill, tile)``.

    ``warp`` lists ``(W, pair indices)``, one ``gotoh_batch_moves`` launch a
    width class (W ascending), for the pairs that ``fill_batch.plan``
    accepts by their own n: at most 1024 columns, an alphabet of at most
    256 and a table that fits in shared memory.  ``fill`` lists the other
    pairs as :func:`ragged_classes` does, a ``gotoh_fill`` ragged launch a
    class, less each class's tail that ``fill_tile.route_tail`` takes;
    ``tile`` lists those tails, one ``gotoh_tile`` launch with codes each.
    ``clusters`` gives a class's plan the clusters of its launch that the
    card holds at once (:func:`_clusters` on a card); without it no class
    is split.  Indices run longest (m * n) first within a launch.  The batch
    size plays no part, as for the cost fills (``fill_batch.plan``): on an
    H100 ``gotoh_batch_moves`` is 4x faster at 1024 pairs of 1024^2 and at
    every B of 256^2, and ~10% slower at 1 to 33 pairs of 1024^2, where a
    lone warp a pair runs and the call's device time is ~1 ms (the moves
    crossover of PERF.md section 6, run by ``chip_smoke.py`` of b226048)."""
    from . import fill_batch

    m = np.asarray(m_true, np.int64)
    n = np.asarray(n_true, np.int64)
    widths = np.array([fill_batch.plan(cols, alphabet) or 0 for cols in n.tolist()],
                      np.int64)
    warp = []
    for width in fill_batch.WIDTHS:
        idx = np.flatnonzero(widths == width)
        if idx.size:
            warp.append((width, idx[np.argsort(-(m[idx] * n[idx]), kind="stable")]))
    rest = np.flatnonzero(widths == 0)
    fill, tile = [], []
    for lp, idx in ragged_classes(m[rest], n[rest], sms):
        idx = rest[idx]
        cut = len(idx) - (0 if clusters is None else fill_tile.route_tail(
            list(zip(m[idx].tolist(), n[idx].tolist())), clusters(lp), sms))
        fill.append((lp, idx[:cut]))
        if cut < len(idx):
            tile.append(idx[cut:])
    return warp, fill, tile


@functools.cache
def _clusters(index: int, alphabet: int, lp: FillPlan) -> int:
    """How many clusters of a ``gotoh_fill`` ragged launch at ``lp`` with an
    (A, A) table card ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``, one query a shape)."""
    from ..utils import cuda_build

    lib = cuda_build.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.gotoh_fill_clusters(lp.width, lp.warps, lp.bands, 1, 1,
                                      alphabet, ctypes.byref(out))
    if err != 0:
        msg = lib.gotoh_fill_error_string(err).decode()
        raise RuntimeError(f"gotoh_fill cluster query failed: CUDA error {err} ({msg})")
    return out.value


@functools.cache
def _side_stream(index: int) -> torch.cuda.Stream:
    """The stream of card ``index`` that a ragged moves fill's ``gotoh_tile``
    launches run on, beside its ``gotoh_fill`` launches."""
    return torch.cuda.Stream(device=index)


def batch_moves_ragged(
    tok_a,
    tok_b,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
    *,
    offsets=None,
    nbytes: int | None = None,
) -> RaggedMoves:
    """Fill every pair of several buckets with codes: a :class:`RaggedMoves`.

    Args:
        tok_a / tok_b: sequences of (B_k, M_k+1) / (B_k, N_k+1) int32
            contiguous 1-origin tokens (column 0 unused), one a bucket, all
            on the CPU or all on one CUDA device.
        cost_mat: (A, A) int32 contiguous costing matrix on that device.
        gap_id / gap_open: the gap token and the gap-open cost.
        m_true / n_true: sequences of (B_k,) host-side true lengths.
        offsets / nbytes: where each pair's codes start in a buffer of
            ``nbytes`` bytes, pairs in bucket order, each a multiple of
            ``ALIGN``; by default packed in order (:func:`ragged_offsets`).
            Regions (:func:`ragged_bytes`) may not overlap.

    Pairs are numbered in bucket order, each bucket's in its order.  On
    CUDA tensors the launches of :func:`ragged_routes` over pair
    descriptors: one ``gotoh_batch_moves`` launch a width class
    (``fill_batch.batch_moves_warp.launches`` counts them), then one
    ``gotoh_fill`` ragged launch a launch class
    (``batch_moves_ragged.launches`` counts them; ``.wide_launches``
    counts those launches again and ``.wide_pairs`` the pairs they take),
    and one ``gotoh_tile`` launch a class's tail on a side stream that
    the current stream waits for (``.tile_launches`` and ``.tile_pairs``
    count them and their pairs; ``fill_tile.gotoh_tile.launches`` too).
    Nothing waits for the card.  On CPU tensors the plain version, the row
    scan pair by pair into the same buffer at the same offsets and
    strides; ``.wide_pairs`` then counts the pairs it fills that
    ``gotoh_batch_moves`` would not take (``fill_batch.plan``) and
    ``.tile_pairs`` none, since the tail depends on how many clusters a
    card holds, and no launch is counted.
    """
    tok_a, tok_b = list(tok_a), list(tok_b)
    with span("fill.batch"):
        device, lengths = _check_buckets(tok_a, tok_b, cost_mat, gap_id, m_true,
                                         n_true)
        layout, nbytes = _ragged_layout(tok_a, tok_b, lengths, offsets, nbytes)
        if device.type == "cuda":
            warp, classes, tails = ragged_routes(
                layout[:, 2], layout[:, 3], cost_mat.shape[0],
                _sms(device.index),
                functools.partial(_clusters, device.index, cost_mat.shape[0]))
            ready = torch.cuda.Event() if tails else None
            out = _launch_warp(warp, [i for _, i in classes] + tails, layout,
                               cost_mat, gap_id, gap_open, nbytes, ready)
    if device.type == "cpu":
        from . import fill_batch

        _ragged_counts.wide_pairs += sum(
            not fill_batch.plan(cols, cost_mat.shape[0])
            for cols in layout[:, 3].tolist())
        return _plain_ragged(tok_a, tok_b, cost_mat, gap_id, gap_open, layout,
                             nbytes)
    if device.type != "cuda":
        raise ValueError(f"no gotoh_fill route for device {device}")
    if classes:
        with span("fill.wide"):
            _ragged_counts.wide_launches += len(classes)
            _ragged_counts.wide_pairs += sum(len(idx) for _, idx in classes)
            _launch_classes(classes, tails, out, cost_mat, gap_id, gap_open)
            if tails:
                _ragged_counts.tile_launches += len(tails)
                _ragged_counts.tile_pairs += sum(len(idx) for idx in tails)
                _launch_tails(tails, ready, out, cost_mat, gap_id, gap_open)
    return out


def _ragged_layout(tok_a, tok_b, lengths, offsets, nbytes):
    """(P, 8) int64 host descriptors of a ragged moves fill's pairs, in
    bucket order, and the bytes of its codes (``batch_moves_ragged``)."""
    m = np.concatenate([mt.numpy() for mt, _ in lengths]).astype(np.int64)
    n = np.concatenate([nt.numpy() for _, nt in lengths]).astype(np.int64)
    sizes = ragged_bytes(m, n)
    if offsets is None:
        packed = ragged_offsets(m, n)
        offsets, nbytes = packed[:-1], int(packed[-1])
    else:
        offsets = np.asarray(offsets, np.int64)
        if offsets.shape != m.shape:
            raise ValueError(f"offsets must have shape {m.shape}")
        ends = offsets + sizes
        nbytes = int(ends.max()) if nbytes is None else int(nbytes)
        by_start = np.argsort(offsets, kind="stable")
        if (offsets < 0).any() or (ends > nbytes).any() or (
            offsets % ALIGN
        ).any() or (offsets[by_start][1:] < ends[by_start][:-1]).any():
            raise ValueError("offsets must place each pair's codes inside "
                             f"{nbytes} bytes at multiples of {ALIGN}, no two "
                             "overlapping")
    layout = np.zeros((len(m), DESC_WORDS), np.int64)
    for word, toks in ((0, tok_a), (1, tok_b)):  # each pair's row of tokens
        layout[:, word] = np.concatenate([
            t.data_ptr() + 4 * t.shape[1] * np.arange(t.shape[0], dtype=np.int64)
            for t in toks
        ])
    layout[:, 2], layout[:, 3] = m, n
    layout[:, 4], layout[:, 5] = offsets, ragged_stride(n)
    layout[:, 6] = np.arange(len(m))
    return layout, nbytes


def _plain_ragged(tok_a, tok_b, cost_mat, gap_id, gap_open, layout, nbytes
                  ) -> RaggedMoves:
    """The plain version of a ragged moves fill: the row scan pair by pair
    into one buffer at ``layout``'s offsets and strides."""
    final3 = torch.empty((len(layout), 3), dtype=torch.int32)
    codes = torch.zeros(nbytes, dtype=torch.uint8)
    rows = [(ta[b], tb[b]) for ta, tb in zip(tok_a, tok_b)
            for b in range(ta.shape[0])]
    for (ta, tb), (_, _, mk, nk, off, ld, row, _) in zip(rows, layout.tolist()):
        res = row_fill(ta[: mk + 1], tb[: nk + 1], cost_mat, gap_id, gap_open,
                       want_moves=True)
        final3[row] = res.final3
        codes[off : off + (mk + 1) * ld].view(mk + 1, ld)[1:, 1 : nk + 1] = (
            res.moves[1:, 1:]
        )
    return RaggedMoves(final3, codes, torch.from_numpy(layout), layout)


def _launch_warp(warp, rest, layout, cost_mat, gap_id, gap_open, nbytes,
                 ready) -> RaggedMoves:
    """A ragged moves fill's descriptors and outputs on the card, and its
    ``gotoh_batch_moves`` launches: ``warp`` as :func:`ragged_routes` gives
    it and ``rest`` the pair indices of its other launches (each
    ``gotoh_fill`` launch class's, then each ``gotoh_tile`` tail's; every
    pair in one launch), over ``layout``, the host descriptors in pair
    order, into a buffer of ``nbytes`` bytes; descriptors in launch order
    come back.  ``ready``, an event or None, is recorded once the outputs
    are held and before the launches: what runs beside them waits on it.
    The other launches are :func:`_launch_classes`' and
    :func:`_launch_tails`'."""
    from . import fill_batch

    device = cost_mat.device
    layout = np.ascontiguousarray(
        layout[np.concatenate([i for _, i in warp] + list(rest))])
    desc = torch.from_numpy(layout).pin_memory().to(device, non_blocking=True)
    final3 = torch.empty((len(layout), 3), dtype=torch.int32, device=device)
    codes = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if ready is not None:
        ready.record(torch.cuda.current_stream(device))
    lo = 0
    for width, idx in warp:
        fill_batch.batch_moves_warp(desc, lo, len(idx), width, cost_mat,
                                    gap_id, gap_open, final3, codes)
        lo += len(idx)
    return RaggedMoves(final3, codes, desc, layout)


def _launch_classes(classes, tails, out: RaggedMoves, cost_mat, gap_id,
                    gap_open) -> None:
    """A ragged moves fill's ``gotoh_fill`` launches, one a launch class,
    over the descriptors of ``out`` (:func:`_launch_warp`'s) past its
    warp-routed pairs and before its ``tails``' pairs."""
    from ..utils import cuda_build

    lib = cuda_build.load()
    final3, codes, desc, layout = out
    device = cost_mat.device
    m, n = layout[:, 2], layout[:, 3]
    lo = len(layout) - sum(len(idx) for _, idx in classes) - sum(
        len(idx) for idx in tails)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lp, idx in classes:
            rows = slice(lo, lo + len(idx))
            m_max, n_max = int(m[rows].max()), int(n[rows].max())
            pass_edge = (  # (B, 2, M+1) int4: a pass's right edge for the next
                torch.empty((len(idx), 2, m_max + 1, 4), dtype=torch.int32,
                            device=device)
                if lp.passes > 1
                else None
            )
            batch_moves_ragged.launches += 1
            err = lib.gotoh_fill_ragged_launch(
                desc.data_ptr() + lo * DESC_WORDS * 8, cost_mat.data_ptr(),
                final3.data_ptr(), codes.data_ptr(),
                None if pass_edge is None else pass_edge.data_ptr(),
                len(idx), m_max, n_max, cost_mat.shape[0], int(gap_id),
                int(gap_open), lp.width, lp.warps, lp.bands, stream,
            )
            if err != 0:
                msg = lib.gotoh_fill_error_string(err).decode()
                raise RuntimeError(
                    f"gotoh_fill ragged launch failed: CUDA error {err} ({msg})"
                )
            lo += len(idx)


def _launch_tails(tails, ready, out: RaggedMoves, cost_mat, gap_id, gap_open
                  ) -> None:
    """A ragged moves fill's ``gotoh_tile`` launches with codes, one a tail
    of ``tails``, over the last descriptors of ``out``, on the card's side
    stream: it waits for ``ready`` (an event after the tokens were queued
    and the outputs held, :func:`_launch_warp`), so the launches start
    beside the ``gotoh_fill`` launches queued before them, on the SMs their
    clusters leave, and the current stream waits for it, so nothing after
    the fill (the walk, the next user of a buffer freed on the current
    stream) runs before them."""
    device = cost_mat.device
    current = torch.cuda.current_stream(device)
    side = _side_stream(device.index)
    lo = len(out.layout) - sum(len(idx) for idx in tails)
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for idx in tails:
            fill_tile.launch_codes(out.layout[lo : lo + len(idx)], out.codes,
                                   out.final3, cost_mat, gap_id, gap_open)
            lo += len(idx)
    current.wait_stream(side)


batch_moves_ragged.launches = 0
batch_moves_ragged.wide_launches = 0
batch_moves_ragged.wide_pairs = 0
batch_moves_ragged.tile_launches = 0
batch_moves_ragged.tile_pairs = 0
# The wide counters are reached through this name, which a wrapper put in
# ``batch_moves_ragged``'s place (a test's call count, a timer) leaves alone.
_ragged_counts = batch_moves_ragged

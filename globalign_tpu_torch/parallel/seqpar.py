"""Sequence parallelism: one pair's DP fill column-sharded across a mesh.

The port of ``globalign_tpu/parallel/seqpar.py``, with its schedule.  seq_2
is split into D contiguous strips of ``W = ceil(n / D)`` columns (rank d
owns columns d*W+1 .. (d+1)*W; columns past n are pad, right of every real
cell, and never feed one) and seq_1 into blocks of ``block_rows`` rows.  At
super-step t rank d fills block ``t - d`` of its strip — a skewed pipeline,
every rank busy once it fills (t >= D - 1), nblocks + D - 1 super-steps in
all.  After each super-step rank d sends its strip's right edge over the
rows it just filled, ``[row above the block at column W, edge]`` (3,
block_rows + 1), to rank d + 1, BIG when it had no block (``comm.shift``).

Each block fill is one ``fill_cuda.strip_fill_block`` call: on CUDA tensors
one launch of ``gotoh_fill``'s strip mode (the port of TPU kernel
``fill_pallas._make_strip_kernel``), on CPU tensors its plain version, the
row scan's ``col0_full`` / ``want_edge`` / ``want_fin_row`` modes.  The
block's state carried to the next block is its row ``rows`` (the fill's
``fin``), not the last padded row: a final block may be partial.

  * :func:`sharded_pair_cost` — the optimal cost lanes of one pair; the
    strip owning column n reads them at its column ``n - dstar*W``;
  * :class:`ShardedCheckpointFill` / :func:`sharded_block_last_rows` — a
    block's last row with injected boundaries, all-gathered and
    reassembled: the checkpoint pass of ``ops.linear_tb.align_blocked``
    over a mesh.

The edge carries clamped lanes (min(., BIG)) where the one-device fill
carries an unclamped Ix chain; they agree because a value at or above BIG
never leads to a real cell.
"""

from __future__ import annotations

import torch

from ..ops.fill_cuda import batch_moves, strip_fill_block
from ..ops.fill_scan import BIG, default_boundary
from . import comm
from .comm import Mesh
from .mesh import make_pair_mesh

DEFAULT_BLOCK_ROWS = 256

# The JAX package names its strip mesh apart; here a mesh is a group's
# ranks, whatever is split over them.
make_strip_mesh = make_pair_mesh


def _pad_rows(x: torch.Tensor, length: int, value=None) -> torch.Tensor:
    """``x`` (..., L) extended to ``length`` along its last axis with
    ``value``, or with copies of its last column when ``value`` is None."""
    extra = length - x.shape[-1]
    if extra <= 0:
        return x
    tail = (
        x[..., -1:].expand(*x.shape[:-1], extra) if value is None
        else x.new_full((*x.shape[:-1], extra), value)
    )
    return torch.cat([x, tail], dim=-1)


def _strip(x: torch.Tensor, d: int, width: int, n: int, fill) -> torch.Tensor:
    """Rank ``d``'s window of columns d*W .. d*W + W of ``x`` (..., n+1):
    its dummy column 0 is global column d*W; columns past n are ``fill``."""
    out = x.new_full((*x.shape[:-1], width + 1), fill)
    c0 = d * width
    if c0 <= n:
        hi = min(width, n - c0)
        out[..., : hi + 1] = x[..., c0 : c0 + hi + 1]
    return out.contiguous()


def _pipeline(
    mesh: Mesh,
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    state: torch.Tensor,
    col0: torch.Tensor,
    m: int,
    block_rows: int,
) -> torch.Tensor:
    """The super-steps over ``m`` rows; returns this rank's strip of row m.

    ``tok_a`` (nblocks*RB + 1,) and ``col0`` (3, nblocks*RB + 1) are the
    rows' tokens and the matrix's column 0 (read by rank 0 only), padded;
    ``tok_b`` (W+1,) and ``state`` (3, W+1) this rank's strip of seq_2 and
    of the row above the first block.
    """
    size, d = mesh.size, mesh.rank
    rb = block_rows
    nblocks = max(1, -(-m // rb))
    idle = torch.full((3, rb + 1), BIG, dtype=torch.int32, device=state.device)
    edges_in = None
    nsteps = nblocks + size - 1
    for t in range(nsteps):
        b = t - d
        edge_out = idle
        if 0 <= b < nblocks:
            i0 = b * rb
            left = col0[:, i0 : i0 + rb + 1].contiguous() if d == 0 else edges_in
            fin, edge = strip_fill_block(
                tok_a[None, i0 : i0 + rb + 1], tok_b[None], cost_mat, gap_id,
                gap_open, state[None], left[None], [min(rb, m - i0)],
            )
            state, edge_out = fin[0], edge[0]
        if t + 1 < nsteps:  # the last step's edge has no reader
            edges_in = comm.shift(mesh, edge_out)
    return state


def sharded_pair_cost(
    mesh: Mesh,
    tok_a: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """Optimal-cost lanes (3,) int32 of ONE pair, column-sharded over ``mesh``.

    Args:
        tok_a / tok_b: (m+1,) / (n+1,) int32 1-origin tokens on this rank's
            device, the same on every rank; ``cost_mat`` (A, A) int32 there.
        block_rows: rows per super-step (the pipeline fills in
            (D - 1) * block_rows rows; each step moves 3 * (block_rows + 1)
            ints a rank).

    ``min`` of the result is the optimal alignment cost, identical to the
    one-device fill; every rank returns it.  With fewer columns than ranks
    the pair is filled whole on each rank (one cost-only ``gotoh_fill``
    launch on the card).
    """
    m, n = tok_a.shape[0] - 1, tok_b.shape[0] - 1
    size = mesh.size
    go = int(gap_open)
    if n < size:
        final3, _ = batch_moves(
            tok_a[None], tok_b[None], cost_mat, gap_id, go, [m], [n],
            want_moves=False,
        )
        return final3[0]
    rb = max(1, block_rows)
    nblocks = max(1, -(-m // rb))
    width = -(-n // size)
    dstar = (n - 1) // width  # the strip owning global column n
    c_read = n - dstar * width
    row0, col0 = default_boundary(tok_a, tok_b, cost_mat, gap_id, go)
    d = mesh.rank
    state = _pipeline(
        mesh,
        _pad_rows(tok_a, nblocks * rb + 1, 0),
        _strip(tok_b, d, width, n, 0),
        cost_mat, gap_id, go,
        _strip(row0, d, width, n, BIG),
        _pad_rows(col0, nblocks * rb + 1),
        m, rb,
    )
    return comm.all_gather(mesh, state[:, c_read].contiguous())[dstar]


class ShardedCheckpointFill:
    """Per-pair context of the column-sharded checkpoint pass.

    Built once per ``align_blocked(mesh=...)`` call: this rank's strip of
    seq_2 is cut once; :meth:`block_last_rows` then chains consecutive
    blocks through a replicated device row, (3, D*W + 1), that every rank
    holds after each block.
    """

    def __init__(
        self,
        mesh: Mesh,
        tok_b: torch.Tensor,
        cost_mat: torch.Tensor,
        gap_id: int,
        gap_open: int,
        *,
        block_rows: int = DEFAULT_BLOCK_ROWS,
    ):
        self.mesh = mesh
        self.n = tok_b.shape[0] - 1
        if self.n < 1:
            raise ValueError("a column-sharded fill needs at least one column")
        self.width = -(-self.n // mesh.size)
        self.block_rows = block_rows
        self.cost_mat = cost_mat
        self.gap_id = gap_id
        self.gap_open = int(gap_open)
        self.tok_b = _strip(tok_b, mesh.rank, self.width, self.n, 0)

    def pad_row0(self, row0: torch.Tensor) -> torch.Tensor:
        """A (3, n+1) row in the (3, D*W + 1) layout the blocks chain
        through (padding is BIG; padded columns never feed real ones)."""
        return _pad_rows(row0, self.mesh.size * self.width + 1, BIG)

    def block_last_rows(
        self, tok_a_blk: torch.Tensor, row0_full: torch.Tensor,
        col0: torch.Tensor,
    ) -> torch.Tensor:
        """The last DP row of one K-row block, (3, D*W + 1), on every rank.

        Args:
            tok_a_blk: (K+1,) 1-origin block tokens on this rank's device.
            row0_full: (3, D*W + 1) the previous block's return, or
                :meth:`pad_row0` of the matrix's row 0.
            col0: (3, K+1) the block's column-0 cells ((BIG, BIG, Iy) rows
                of the matrix's column 0).
        """
        k = tok_a_blk.shape[0] - 1
        rb = max(1, min(self.block_rows, k))
        nblocks = max(1, -(-k // rb))
        d, width = self.mesh.rank, self.width
        state = _pipeline(
            self.mesh,
            _pad_rows(tok_a_blk, nblocks * rb + 1, 0),
            self.tok_b, self.cost_mat, self.gap_id, self.gap_open,
            row0_full[:, d * width : d * width + width + 1].contiguous(),
            _pad_rows(col0, nblocks * rb + 1),
            k, rb,
        )
        # Column 0 is the block's last column-0 cell, columns 1..D*W the
        # strips' interiors in rank order.
        gathered = comm.all_gather(self.mesh, state)  # (D, 3, W+1)
        body = gathered[:, :, 1:].permute(1, 0, 2).reshape(3, -1)
        return torch.cat([col0[:, k : k + 1], body], dim=1)


def sharded_block_last_rows(
    mesh: Mesh,
    tok_a_blk: torch.Tensor,
    tok_b: torch.Tensor,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    row0: torch.Tensor,
    col0: torch.Tensor,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """Last DP row (3, n+1) of a K-row block, column-sharded over ``mesh``.

    One-shot form of :class:`ShardedCheckpointFill`: ``row0`` (3, n+1) is
    the row above the block, ``col0`` (3, K+1) its column-0 cells.  The row
    is bit-identical to the one-device block fill
    (``fill_cuda.batch_last_rows``).
    """
    ctx = ShardedCheckpointFill(
        mesh, tok_b, cost_mat, gap_id, gap_open, block_rows=block_rows
    )
    full = ctx.block_last_rows(tok_a_blk, ctx.pad_row0(row0), col0)
    return full[:, : ctx.n + 1]

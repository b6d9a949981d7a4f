"""Data-parallel sharding of a bucket of pairs over a mesh.

The port of ``globalign_tpu/parallel/mesh.py``.  A bucket's batch axis is
split over the mesh's ranks: the batch is padded to a multiple of the mesh
size with copies of pair 0 (dropped after), rank r fills rows
r*Bl .. (r+1)*Bl - 1, and every pair's final lanes are all-gathered so
every rank holds the whole result (each pair's DP lives on one device; no
per-cell traffic crosses the mesh).

  * :func:`sharded_fill_costs` — each rank's shard through
    ``fill_batch.batch_final3``, then an all-gather of final3;
  * :func:`sharded_fill_moves` — each rank's shard through
    ``fill_cuda.batch_moves``.  The codes stay on the rank's device and
    the caller walks them there (``linear_tb.walk_block``); only final3 is
    gathered.  The JAX function fetches every shard's codes to the host,
    because its walk ran there.

Not ported: the lane plans, skew and unskew, and the bitmask retry latch of
the JAX module (:324-455, :496-561) — workarounds for Mosaic that a CUDA
thread reading the cost table at any index does not need.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fill_batch, fill_cuda
from . import comm
from .comm import Mesh


def make_pair_mesh(group=None) -> Mesh:
    """A mesh over ``group``'s ranks (default: every rank of the world);
    raises if no process group is up."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call globalign_tpu_torch.parallel.multihost."
            "initialize() first (num_processes=1 for a world of one)"
        )
    return Mesh(group)


def pad_batch_to_mesh(arrays, batch: int, mesh: Mesh) -> tuple[list, int]:
    """Pad every array's leading axis to a multiple of the mesh size.

    Padding replicates row 0 (a valid pair — results for pad rows are simply
    dropped by the caller).  Returns (padded_arrays, padded_batch).
    """
    size = mesh.size
    padded = -(-batch // size) * size
    if padded == batch:
        return list(arrays), batch
    out = []
    for a in arrays:
        pad = np.broadcast_to(a[:1], (padded - batch,) + a.shape[1:])
        out.append(np.concatenate([a, pad], axis=0))
    return out, padded


def local_shard(arrays, batch: int, mesh: Mesh) -> list[np.ndarray]:
    """This rank's rows of each array, padded as :func:`pad_batch_to_mesh`."""
    padded, total = pad_batch_to_mesh(
        [np.asarray(a) for a in arrays], batch, mesh
    )
    per = total // mesh.size
    lo = mesh.rank * per
    return [a[lo : lo + per] for a in padded]


def gather_batch(mesh: Mesh, tensor: torch.Tensor, batch: int) -> torch.Tensor:
    """Every rank's shard of a padded batch, in rank order, pad dropped."""
    parts = comm.all_gather(mesh, tensor)
    return parts.reshape(-1, *tensor.shape[1:])[:batch]


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    tensor = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int32))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor


def sharded_fill_costs(
    mesh: Mesh,
    tok_a,
    tok_b,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
) -> torch.Tensor:
    """Cost-only batched fill, batch axis sharded across ``mesh``.

    Args:
        tok_a / tok_b: (B, M+1) / (B, N+1) host int32 1-origin tokens, the
            same on every rank.
        cost_mat: (A, A) int32 on this rank's device (the fill's device).
        m_true / n_true: (B,) host-side true lengths.

    Returns (B, 3) int32 final lanes on that device, the same on every rank.
    """
    batch = len(tok_a)
    ta, tb, mt, nt = local_shard((tok_a, tok_b, m_true, n_true), batch, mesh)
    dev = cost_mat.device
    final3 = fill_batch.batch_final3(
        _upload(ta, dev), _upload(tb, dev), cost_mat, gap_id, gap_open,
        mt.tolist(), nt.tolist(),
    )
    return gather_batch(mesh, final3, batch)


class ShardMoves(NamedTuple):
    """:func:`sharded_fill_moves`' result: every pair's final lanes, and
    this rank's shard — its codes, lanes and true lengths (pad rows are
    copies of pair 0)."""

    final3: torch.Tensor  # (B, 3), the same on every rank
    moves: torch.Tensor  # (Bl, M+1, N+1) uint8, this rank's shard
    shard_final3: torch.Tensor  # (Bl, 3)
    shard_m: list[int]
    shard_n: list[int]


def sharded_fill_moves(
    mesh: Mesh,
    tok_a,
    tok_b,
    cost_mat: torch.Tensor,
    gap_id: int,
    gap_open: int,
    m_true,
    n_true,
) -> ShardMoves:
    """Traceback-capable batched fill, batch axis sharded across ``mesh``.

    Arguments as in :func:`sharded_fill_costs`.  Each rank fills its shard
    with ``fill_cuda.batch_moves``; its row-major codes stay on its device
    for a walk there, and final3 is all-gathered.
    """
    batch = len(tok_a)
    ta, tb, mt, nt = local_shard((tok_a, tok_b, m_true, n_true), batch, mesh)
    dev = cost_mat.device
    shard_m, shard_n = mt.tolist(), nt.tolist()
    final3, moves = fill_cuda.batch_moves(
        _upload(ta, dev), _upload(tb, dev), cost_mat, gap_id, gap_open,
        shard_m, shard_n,
    )
    return ShardMoves(
        gather_batch(mesh, final3, batch), moves, final3, shard_m, shard_n
    )

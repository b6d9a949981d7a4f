"""The mesh and its collectives over ``torch.distributed``.

A :class:`Mesh` is the port's counterpart of a 1-D ``jax.sharding.Mesh``:
the ranks of one process group, each driving one device (one rank per
card on NCCL; on gloo several ranks may share a card).  The semantics are
lockstep SPMD, as in multi-controller JAX: every rank calls a mesh function
with the same arguments, the calls post the same collectives in the same
order, and every rank gets the same (replicated) result.  A world of one is
a valid mesh and gives the results of no mesh.

The transport follows the group's backend.  NCCL moves CUDA tensors where
they lie, on the current stream.  Gloo moves CPU tensors, so a CUDA tensor
crosses a gloo group staged through pinned host memory (copy out, exchange,
copy back): the transport of ranks that share one card, where NCCL refuses
a second rank.  A CPU tensor on an NCCL group raises.  The two collectives
the port needs replace the JAX package's:

  * :func:`shift` — ``lax.ppermute`` from rank d to d + 1, the strip-edge
    halo of ``parallel/seqpar.py``; the wrap-around (D - 1 to 0) is not
    sent, because rank 0's left edge is the matrix's own column 0;
  * :func:`all_gather` — ``lax.all_gather``, the replicated results.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The ranks of one process group (``None``: the default group), in
    rank order.  Build one with ``mesh.make_pair_mesh`` (or its alias
    ``seqpar.make_strip_mesh``) after ``multihost.initialize``."""

    group: dist.ProcessGroup | None = None

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this mesh's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def _staged(mesh: Mesh, tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` crosses ``mesh`` through host memory."""
    if mesh.backend == dist.Backend.NCCL:
        if tensor.device.type != "cuda":
            raise ValueError(
                f"an NCCL mesh moves CUDA tensors, got one on {tensor.device}; "
                "use a gloo group for CPU tensors"
            )
        return False
    return tensor.device.type == "cuda"


def _to_wire(tensor: torch.Tensor, staged: bool) -> torch.Tensor:
    if not staged:
        return tensor.contiguous()
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)  # waits for the producing kernel
    return host


def shift(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor | None:
    """Send ``tensor`` to rank d + 1; return what rank d - 1 sent (None on
    rank 0, to which nothing is sent).  Every rank sends a tensor of the
    same shape and type.  Sends and receives are posted together
    (``batch_isend_irecv``), so no order of ranks can deadlock."""
    size, rank = mesh.size, mesh.rank
    if size == 1:
        return None
    staged = _staged(mesh, tensor)
    wire = _to_wire(tensor, staged)
    ops, received = [], None
    if rank + 1 < size:
        ops.append(dist.P2POp(
            dist.isend, wire, mesh.global_rank(rank + 1), mesh.group
        ))
    if rank > 0:
        received = torch.empty_like(wire)
        ops.append(dist.P2POp(
            dist.irecv, received, mesh.global_rank(rank - 1), mesh.group
        ))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if received is None or not staged:
        return received
    return received.to(tensor.device)


def all_gather(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` (same shape on all), stacked in rank order:
    (D, *shape) on ``tensor``'s device, the same on every rank."""
    staged = _staged(mesh, tensor)
    wire = _to_wire(tensor, staged)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.stack(parts)
    return out.to(tensor.device) if staged else out


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of ``mesh`` has reached this call."""
    if mesh.backend == dist.Backend.NCCL:
        dist.barrier(group=mesh.group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=mesh.group)

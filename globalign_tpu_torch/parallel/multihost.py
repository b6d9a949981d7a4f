"""Multi-process runs: the process group, hosts, chunk dealing and output
shards.

The port of ``globalign_tpu/parallel/multihost.py``.  A JAX process drives
every chip of its host; here a process is one rank, which drives one card,
and the ranks of one host stand together for the JAX process:

  * :func:`initialize` joins (or starts) the ``torch.distributed`` process
    group — the counterpart of ``jax.distributed.initialize``;
  * :func:`host_group` groups the ranks by host, a subgroup per host: the
    mesh of the batch CLI's ``--shard``, on which a host's ranks run its
    chunks in lockstep;
  * :func:`owns_chunk` deals the runner's resumable chunks round-robin over
    hosts (or over ranks, without ``--shard``), and :func:`part_path` gives
    each its own output shard and manifest.
"""

from __future__ import annotations

import datetime
import os
import socket
from pathlib import Path

import torch
import torch.distributed as dist

# How long a collective may wait for the other ranks before it fails the
# run instead of hanging it.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> tuple[int, int]:
    """Join (or start) the process group; returns (rank, world size).

    ``coordinator_address`` (``host:port`` of rank 0, or a URL such as
    ``file:///shared/path``) with ``num_processes`` and ``process_id``
    rendezvous there;
    ``num_processes=1`` alone starts a world of one; with none of them the
    group comes from torchrun's environment (``env://``).  Anything else
    raises rather than guess a cluster — a guess would run every chunk on
    every host.  ``backend`` defaults to NCCL where CUDA is present and
    gloo otherwise; NCCL needs one card per rank, gloo ranks may share one
    (their exchanges are staged through host memory).  Where CUDA is
    present the rank's current card becomes ``LOCAL_RANK`` (else the rank)
    modulo the cards it sees.  Safe to call more than once: later calls
    return the group already up.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs: dict = {"backend": backend, "timeout": timeout}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id"
            )
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        kwargs.update(
            init_method=coordinator_address,
            world_size=int(num_processes),
            rank=int(process_id),
        )
        rank = int(process_id)
    elif num_processes == 1:
        kwargs.update(store=dist.HashStore(), world_size=1, rank=0)
        rank = 0
    elif all(key in os.environ for key in _ENV_KEYS):
        kwargs.update(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        raise RuntimeError(
            "no process group to join: give coordinator_address, "
            "num_processes and process_id, launch under torchrun (env://), "
            "or pass num_processes=1 for a world of one"
        )
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)
    return dist.get_rank(), dist.get_world_size()


def process_info() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _ranks_per_host() -> int:
    """The ranks that share this rank's host name, checked to be the same
    count on every host and consecutive in rank order."""
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    per = names.count(names[dist.get_rank()])
    if len(names) % per or any(
        names[k] != names[k - k % per] for k in range(len(names))
    ):
        raise RuntimeError(
            f"ranks are not grouped in equal, consecutive blocks per host: "
            f"{names}; set LOCAL_WORLD_SIZE"
        )
    return per


def host_group() -> tuple[int, int, dist.ProcessGroup]:
    """(host index, host count, this host's ranks as a subgroup).

    A host's ranks are consecutive; their count is ``LOCAL_WORLD_SIZE``
    where torchrun (or the caller) sets it, else the ranks that share this
    host's name.  Collective: every rank of the world calls it.
    """
    world, rank = dist.get_world_size(), dist.get_rank()
    if "LOCAL_WORLD_SIZE" in os.environ:
        per = int(os.environ["LOCAL_WORLD_SIZE"])
    else:
        per = _ranks_per_host()
    if per < 1 or world % per:
        raise ValueError(f"{world} ranks do not split into hosts of {per}")
    group, _ = dist.new_subgroups(group_size=per)
    return rank // per, world // per, group


def owns_chunk(chunk_id: int, process_id: int, num_processes: int) -> bool:
    """Round-robin deal of resumable chunks over host processes."""
    if num_processes <= 1:
        return True
    return chunk_id % num_processes == process_id


def part_path(output, process_id: int, num_processes: int) -> Path:
    """Per-process output shard path (``<output>.part<k>`` when P > 1).

    Each process appends results and journals its own manifest; shards
    concatenate into the single-process output (row indices are global).
    """
    output = Path(output)
    if num_processes <= 1:
        return output
    return output.with_name(output.name + f".part{process_id}")

"""Host-sharded batch runs: chunk dealing and per-process output shards.

The port of the two pure helpers of ``globalign_tpu/parallel/multihost.py``
(:77-93) that the batch runner needs: :func:`owns_chunk` deals the runner's
resumable chunks round-robin over processes, and :func:`part_path` gives
each process its own output shard and manifest.  The process-group set-up
(``initialize``, which joins ``jax.distributed`` in the JAX package) is not
ported yet; a single process runs every chunk.
"""

from __future__ import annotations

from pathlib import Path


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

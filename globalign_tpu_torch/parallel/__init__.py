"""The port of ``globalign_tpu/parallel``, on ``torch.distributed``: the
mesh and its collectives (``comm``), process groups and hosts
(``multihost``), pair-sharded fills (``mesh``) and the column-sharded
sequence-parallel fill (``seqpar``)."""

from . import comm, mesh, multihost, seqpar
from .comm import Mesh
from .mesh import make_pair_mesh, sharded_fill_costs, sharded_fill_moves
from .seqpar import (
    ShardedCheckpointFill,
    make_strip_mesh,
    sharded_block_last_rows,
    sharded_pair_cost,
)

__all__ = [
    "comm",
    "mesh",
    "multihost",
    "seqpar",
    "Mesh",
    "make_pair_mesh",
    "sharded_fill_costs",
    "sharded_fill_moves",
    "ShardedCheckpointFill",
    "make_strip_mesh",
    "sharded_block_last_rows",
    "sharded_pair_cost",
]

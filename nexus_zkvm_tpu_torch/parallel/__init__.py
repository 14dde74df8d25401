"""The prover over several devices: ``torch.distributed`` meshes.

The JAX package shards over a device mesh with ``shard_map`` and XLA's
SPMD partitioner; the port runs one process (rank) per device, joined
in a ``torch.distributed`` process group (NCCL on cards, gloo on the
CPU or for ranks that share one card):

* ``distributed`` joins the group (the JAX package's environment
  contract, or torchrun's);
* ``mesh`` is the group as a mesh with its collectives: gather,
  all_to_all, disjoint sum, broadcast;
* ``commit`` is the row-windowed LDE + Merkle commitment: each rank
  transforms its share of the columns (kernel K1), an all_to_all leaves
  it the row window of every column, and it hashes its window (K2);
  only the subtree roots are gathered;
* ``context`` is the active mesh, under which ``prove`` keeps each
  rank's window of every committed group and runs every phase on it:
  the proof equals a single process's.

Ranks are processes started by any launcher (torchrun, or
``torch.multiprocessing``); each calls ``init_distributed`` first.
"""

from .mesh import make_mesh, local_mesh
from .commit import sharded_commit_columns
from .context import set_mesh, active_mesh, use_mesh, shard_rows
from .distributed import init_distributed, is_distributed, process_info

__all__ = ["make_mesh", "local_mesh", "sharded_commit_columns",
           "set_mesh", "active_mesh", "use_mesh", "shard_rows",
           "init_distributed", "is_distributed", "process_info"]

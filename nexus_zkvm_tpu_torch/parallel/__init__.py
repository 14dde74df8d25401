"""The prover over several devices: ``torch.distributed`` meshes.

The JAX package shards over a device mesh with ``shard_map`` and XLA's
SPMD partitioner; the port runs one process (rank) per device, joined
in a ``torch.distributed`` process group (NCCL on cards, gloo on the
CPU or for ranks that share one card):

* ``distributed`` joins the group (the JAX package's environment
  contract, or torchrun's);
* ``mesh`` is the group as a mesh with its one collective, a gather;
* ``commit`` is the sharded LDE + Merkle commitment: each rank
  transforms its share of the columns (kernel K1) and hashes its share
  of the rows (K2); the evaluations and every tree layer are gathered;
* ``context`` is the active mesh, under which ``prove`` commits its
  resident size groups and FRI layers through ``commit``, and every
  other phase runs on every rank: the proof equals a single process's.

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

"""The active mesh: the whole prover under a mesh.

The JAX package places every committed column matrix with its row axis
sharded and lets XLA's partitioner spread the whole prover over the
mesh.  PyTorch has no partitioner, so the port's route is explicit:
``prover.stark.prove`` reads the active mesh once and, under a mesh of
two or more ranks, streams nothing and commits every size group whose
rows split through ``parallel/commit.py``: the rank keeps the
coefficients of its share of the columns and the committed-order row
window of the evaluations and tree.  Of a component whose natural rows
split, the rank keeps only its natural-order row window of the main and
preprocessed values (and the halo its gen tape reads) and generates the
interaction for that window alone (K7's operands, then K6 with the
LogUp running sum carried in from the ranks before it); the windows are
committed through step 0 of ``parallel/commit.py``.  The OODS samples,
the composition (K7 on the rank's window of each 4x domain), the
quotients, the FRI folds and the openings then run on what the rank
holds, joined by a few collectives, so each rank holds the same proof,
byte for byte the proof of a single process.  Emulation and fills run
whole on every rank.  The verifiers never read the mesh.

Usage (every rank)::

    from nexus_zkvm_tpu_torch.parallel import make_mesh, use_mesh
    with use_mesh(make_mesh()):
        proof = prove_machine(view, trace)
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["set_mesh", "active_mesh", "use_mesh", "shard_rows"]

_ACTIVE = None


def set_mesh(mesh) -> None:
    """Set (or clear, with ``None``) the process-wide active mesh."""
    global _ACTIVE
    _ACTIVE = mesh


def active_mesh():
    return _ACTIVE


@contextmanager
def use_mesh(mesh):
    """Scoped activation: the prover shards its commitments over
    ``mesh`` inside."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def shard_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's window of the last (row) axis of ``t`` under the
    active mesh.  ``t`` itself when no mesh is active or the axis does
    not divide evenly (tiny tables stay whole)."""
    mesh = _ACTIVE
    if mesh is None or mesh.size <= 1 or t.dim() == 0 or \
            t.shape[-1] % mesh.size:
        return t
    w = t.shape[-1] // mesh.size
    return t[..., mesh.rank * w:(mesh.rank + 1) * w]

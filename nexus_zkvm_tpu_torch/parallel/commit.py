"""Sharded LDE + Merkle commitment over a mesh.

The port of the JAX package's ``parallel/commit.py`` (its ``shard_map``
FFT and row-resharded Merkle tree).  Rank r of a mesh of D ranks, on a
(C, 2^n) column matrix committed on the 2^s domain (M = 2^s rows):

1. takes its share of the columns, k = ceil(C / D) of them (the last
   shares may be shorter; they are padded to k rows for the gather, and
   a pad row is never hashed, since that would change the root);
2. interpolates its share (K1), evaluates it on the 2^s domain (K1) and
   permutes the evaluations to committed (bit-reversed) order;
3. gathers the coefficients and the committed evaluations of every rank
   in one ``all_gather``, so every rank holds the (C, 2^n) and (C, M)
   matrices that the replicated phases of the prover read;
4. hashes its row window [r·M/D, (r+1)·M/D) of the evaluations (K2
   leaves, reading the strided transpose in place);
5. climbs its subtree to one digest (K2 parents);
6. gathers every layer of every subtree, so every rank holds the whole
   tree layer by layer (the openings read any layer);
7. climbs the top log2 D layers (K2 parents).

The tree equals ``merkle.commit_matrix`` on the same evaluations, layer
for layer, so sharding never changes the transcript.  Under an active
profile (``utils.profile``) the steps are timed as the scopes
``mesh_lde`` (1-2), ``mesh_gather`` (3, 6), ``mesh_leaves`` (4) and
``mesh_climb`` (5, 7).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cfft, merkle
from ..ops.blake2s import hash_parents, hash_rows
from ..ops.circle import dev_bit_reverse, dev_layout_to_natural
from ..utils.device import from_u32
from ..utils.profile import scope
from .mesh import Mesh

__all__ = ["sharded_commit_columns", "sharded_lde", "commit_group",
           "commit_matrix", "shards_rows"]


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    assert 1 << k == n, f"{n} is not a power of two"
    return k


def shards_rows(mesh: Mesh | None, M: int) -> bool:
    """Whether ``mesh`` splits the rows of an M-row tree: two or more
    ranks, each with a whole power-of-two window."""
    return mesh is not None and mesh.size > 1 and M % mesh.size == 0


def _lde_share(mesh: Mesh, mat: torch.Tensor, n: int, s: int,
               natural: bool) -> tuple:
    """Steps 1-2 into the flat buffer this rank sends: its k rows of
    coefficients (when ``mat`` is natural-order values), then its k rows
    of committed evaluations, zero past its share.  Returns (buffer,
    row widths, k)."""
    C = int(mat.shape[0])
    k = -(-C // mesh.size)
    lo = min(mesh.rank * k, C)
    c = min(lo + k, C) - lo
    widths = ([1 << n] if natural else []) + [1 << s]
    send = torch.zeros(k * sum(widths), dtype=torch.int32, device=mat.device)
    if c:
        cf = mat[lo:lo + c]
        if natural:
            cf = cfft.interpolate(
                cf[:, dev_layout_to_natural(n, mat.device)],
                out=send[:k << n].view(k, 1 << n)[:c])
        ev = cfft.evaluate(cf, s)
        torch.index_select(ev, 1, dev_bit_reverse(s, mat.device),
                           out=send[k * (widths[0] if natural else 0):]
                           .view(k, 1 << s)[:c])
        del ev
    return send, widths, k


def commit_group(mesh: Mesh, mat: torch.Tensor, n: int, s: int,
                 natural: bool = True) -> tuple:
    """Commit a (C, 2^n) size group on the 2^s domain over ``mesh``
    (steps 1-7).  ``mat``: natural-order values (``natural``) or
    coefficients, the same on every rank; C need not divide by the
    mesh's size (ranks past the last column send an empty share).
    Returns (coefficients, committed evaluations (C, 2^s), MerkleTree);
    the coefficients are ``mat`` itself when it holds them."""
    C = int(mat.shape[0])
    if (1 << s) % mesh.size:
        raise ValueError(f"2^{s} rows do not split over {mesh.size} ranks")
    with scope("mesh_lde"):
        send, widths, k = _lde_share(mesh, mat, n, s, natural)
    with scope("mesh_gather"):
        got = mesh.gather_flat(send)
        del send
        outs = [torch.empty((C, w), dtype=torch.int32, device=mat.device)
                for w in widths]
        for r in range(mesh.size):
            lo = r * k
            c = min(k, C - lo)
            if c <= 0:
                break
            off = 0
            for out, w in zip(outs, widths):
                out[lo:lo + c] = got[r, off:off + c * w].view(c, w)
                off += k * w
        del got
    ev = outs[-1]
    return (outs[0] if natural else mat), ev, commit_matrix(mesh, ev)


def commit_matrix(mesh: Mesh | None, ev: torch.Tensor) -> merkle.MerkleTree:
    """Steps 4-7 on a (C, M) committed-order matrix that every rank
    holds: the tree of ``merkle.commit_matrix(ev)``, its leaves and
    subtrees split over the ranks.  Without a mesh that splits M rows it
    is ``merkle.commit_matrix(ev)`` itself."""
    M = int(ev.shape[1])
    if not shards_rows(mesh, M):
        return merkle.commit_matrix(ev)
    D, d = mesh.size, _log2(M)
    w = M // D
    with scope("mesh_leaves"):
        sub = [hash_rows(ev[:, mesh.rank * w:(mesh.rank + 1) * w].t())]
    with scope("mesh_climb"):
        while sub[-1].shape[0] > 1:
            sub.append(hash_parents(sub[-1]))
    layers: list = [None] * (d + 1)
    with scope("mesh_gather"):
        got = mesh.gather_flat(torch.cat([x.reshape(-1) for x in sub]))
        off = 0
        for j, x in enumerate(sub):
            words = 8 * int(x.shape[0])
            layers[d - j] = got[:, off:off + words].reshape(-1, 8) \
                .to(ev.device).contiguous()
            off += words
        del got, sub
    with scope("mesh_climb"):
        for dd in range(_log2(D) - 1, -1, -1):
            layers[dd] = hash_parents(layers[dd + 1])
    return merkle.MerkleTree(layers=layers, columns=[], matrix=ev,
                             sharded=True)


def _columns(mesh: Mesh, columns) -> torch.Tensor:
    return (from_u32(columns, mesh.device) if isinstance(columns, np.ndarray)
            else columns.to(device=mesh.device, dtype=torch.int32))


def sharded_lde(mesh: Mesh, columns, trace_log: int,
                eval_log: int) -> torch.Tensor:
    """(C, 2^trace_log) natural-order columns -> their (C, 2^eval_log)
    committed-order evaluations, each rank transforming its share of the
    columns; every rank gets the whole matrix."""
    mat = _columns(mesh, columns)
    with scope("mesh_lde"):
        send, _widths, k = _lde_share(mesh, mat, trace_log, eval_log, True)
        ev = send[k << trace_log:].view(k, 1 << eval_log)
    with scope("mesh_gather"):
        return mesh.all_gather(ev)[:int(mat.shape[0])]


def sharded_commit_columns(mesh: Mesh, columns, trace_log: int,
                           log_blowup: int) -> tuple:
    """Shard-parallel commit of equal-size columns: (C, 2^trace_log)
    natural order (numpy uint32 or an int32 tensor).  Returns
    (committed evaluations (C, M) on the mesh's device, root (8,) numpy
    uint32), the values of the single-process ``pcs`` commit.  M must
    split over the mesh; C need not."""
    _cf, ev, tree = commit_group(mesh, _columns(mesh, columns), trace_log,
                                 trace_log + log_blowup)
    return ev, tree.root()

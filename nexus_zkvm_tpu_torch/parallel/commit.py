"""Row-windowed LDE + Merkle commitment over a mesh.

The port of the JAX package's ``parallel/commit.py`` (its ``shard_map``
FFT and row-resharded Merkle tree), and the layout a rank keeps of every
committed size group under a mesh.  Rank r of a mesh of D ranks, on a
(C, 2^n) column matrix committed on the 2^s domain (M = 2^s rows) whose
rows split (:func:`shards_rows`: a window of at least ``MIN_WINDOW``
rows a rank):

0. (a group given as row windows, :func:`commit_windows`: rank r holds
   the natural-order rows [r·2^n/D, (r+1)·2^n/D) of all C columns) sends
   the rows of rank j's share of the columns to rank j in one
   ``all_to_all``, so it holds all 2^n rows of its own share;
1. takes its share of the columns, k = ceil(C / D) of them (the last
   shares may be shorter or empty: past C a rank sends zero rows, which
   no rank keeps);
2. interpolates its share (K1) when given natural-order values (these
   coefficients are the share it keeps), evaluates it on the 2^s domain
   (K1) and permutes the evaluations to committed (bit-reversed) order;
3. sends window j of its share's evaluations to rank j in one
   ``all_to_all``, so it holds the committed-order row window
   [r·M/D, (r+1)·M/D) of all C columns;
4. hashes its window (K2 leaves, reading the strided transpose in
   place);
5. climbs its subtree to one digest (K2 parents);
6. gathers the D subtree roots;
7. climbs the top log2 D layers (K2 parents), which every rank keeps.

A rank's tree (``merkle.MerkleTree`` with a ``window``) holds the layers
of its window below the top, and the whole top; its root equals
``merkle.commit_matrix`` on the whole evaluations, so sharding never
changes the transcript.  A group whose rows do not split is held whole
by every rank.  Under an active profile (``utils.profile``) the steps
are timed as the scopes ``mesh_lde`` (1-2), ``mesh_exchange`` (0, 3,
6; step 0 also as ``mesh_exchange/mesh_share``), ``mesh_leaves`` (4)
and ``mesh_climb`` (5, 7).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import blake2s, cfft, merkle
from ..ops.circle import dev_bit_reverse, dev_layout_to_natural
from ..utils.device import from_u32
from ..utils.profile import scope
from .mesh import Mesh

__all__ = ["sharded_commit_columns", "sharded_lde", "commit_group",
           "commit_windows", "gather_share", "commit_window", "shards_rows",
           "window", "share", "Share", "MIN_WINDOW"]

# the fewest rows of a window: a group (or FRI layer, or composition
# domain) of fewer than MIN_WINDOW rows a rank is held whole by every rank
MIN_WINDOW = 1 << 5


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    assert 1 << k == n, f"{n} is not a power of two"
    return k


def shards_rows(mesh: Mesh | None, M: int) -> bool:
    """Whether ``mesh`` splits M rows: two or more ranks, each with a
    whole window of at least ``MIN_WINDOW`` rows.  Every rank decides
    the same from the shapes alone."""
    return mesh is not None and mesh.size > 1 and M % mesh.size == 0 \
        and M // mesh.size >= MIN_WINDOW


def window(mesh: Mesh | None, M: int) -> tuple:
    """The rows [lo, hi) of M that this rank holds: its window when
    ``mesh`` splits them, else all of them."""
    if not shards_rows(mesh, M):
        return 0, M
    w = M // mesh.size
    return mesh.rank * w, (mesh.rank + 1) * w


@dataclass(frozen=True)
class Share:
    """What one rank holds of a size group of C columns on M committed
    rows: the coefficients of columns ``cols`` and the evaluations of
    rows ``rows``.  ``size`` 1: the whole group (held by every rank)."""
    size: int
    rank: int
    C: int
    M: int

    @property
    def k(self) -> int:
        return -(-self.C // self.size)

    @property
    def cols(self) -> tuple:
        lo = min(self.rank * self.k, self.C)
        return lo, min(lo + self.k, self.C)

    @property
    def rows(self) -> tuple:
        w = self.M // self.size
        return self.rank * w, (self.rank + 1) * w

    def owner(self, j: int) -> int:
        """The rank holding the coefficients of column j."""
        return j // self.k


def share(mesh: Mesh | None, C: int, M: int) -> Share:
    """This rank's :class:`Share` of a (C, M) group under ``mesh``."""
    if shards_rows(mesh, M):
        return Share(mesh.size, mesh.rank, C, M)
    return Share(1, 0, C, M)


def _lde(mat: torch.Tensor, n: int, s: int, natural: bool):
    """(coefficients, committed-order evaluations on 2^s) of (c, 2^n)
    natural-order values (``natural``) or coefficients."""
    cf = (cfft.interpolate(mat[:, dev_layout_to_natural(n, mat.device)])
          if natural else mat)
    ev = cfft.evaluate(cf, s)
    return cf, ev[:, dev_bit_reverse(s, mat.device)]


def _lde_share(mesh: Mesh, parts: list, C: int, n: int, s: int,
               natural: bool) -> tuple:
    """Steps 1-2 on this rank's share (``parts``: its (c, 2^n) columns
    of the C, natural-order values or coefficients; the list is emptied):
    its coefficients and the (D, k·w) buffer it sends, row j window j of
    its share's committed evaluations (zero past its share)."""
    cf = parts.pop()
    sh = Share(mesh.size, mesh.rank, C, 1 << s)
    D, w, c = mesh.size, (1 << s) // mesh.size, int(cf.shape[0])
    send = torch.zeros((D, sh.k, w), dtype=torch.int32, device=cf.device)
    if c:
        cf = (cfft.interpolate(cf[:, dev_layout_to_natural(n, cf.device)])
              if natural else cf.clone())
        ev = cfft.evaluate(cf, s)
        brev = dev_bit_reverse(s, cf.device)
        for j in range(D):
            torch.index_select(ev, 1, brev[j * w:(j + 1) * w],
                               out=send[j, :c])
        del ev
    return cf, send.view(D, -1)


def _commit_share(mesh: Mesh, parts: list, C: int, n: int, s: int,
                  natural: bool) -> tuple:
    """Steps 1-7 from this rank's share of the columns (``parts``, as
    `_lde_share` takes it)."""
    if not shards_rows(mesh, 1 << s):
        raise ValueError(f"2^{s} rows do not split over {mesh.size} ranks")
    k, w = -(-C // mesh.size), (1 << s) // mesh.size
    with scope("mesh_lde"):
        cf, send = _lde_share(mesh, parts, C, n, s, natural)
    with scope("mesh_exchange"):
        got = mesh.all_to_all(send).view(mesh.size, k, w)
        del send
        ev = (got.view(C, w) if k * mesh.size == C else
              torch.cat([got[q, :min(k, C - q * k)]
                         for q in range(mesh.size) if q * k < C]))
        del got
    return cf, ev, commit_window(mesh, ev)


def commit_group(mesh: Mesh, mat: torch.Tensor, n: int, s: int,
                 natural: bool = True) -> tuple:
    """Commit a (C, 2^n) size group on the 2^s domain over ``mesh``
    (steps 1-7).  ``mat``: natural-order values (``natural``) or
    coefficients, the same on every rank; C need not divide by the
    mesh's size.  Returns (this rank's coefficients, (c, 2^n), columns
    ``share(...).cols``; its (C, M/D) window of the committed
    evaluations; its tree)."""
    C = int(mat.shape[0])
    lo, hi = Share(mesh.size, mesh.rank, C, 1 << s).cols
    return _commit_share(mesh, [mat[lo:hi]], C, n, s, natural)


def gather_share(mesh: Mesh, windows: list) -> torch.Tensor:
    """Step 0: this rank's (C, w) natural-order row window [r·w, (r+1)·w)
    of a (C, D·w) matrix (``windows``: the one tensor, or its blocks of
    consecutive columns; the list is emptied) -> the (c, D·w) natural
    rows of its share of the columns (``Share.cols``; c may be 0), in
    one ``all_to_all``."""
    D = mesh.size
    C = sum(int(b.shape[0]) for b in windows)
    w = int(windows[0].shape[1])
    k = -(-C // D)
    send = torch.zeros((D * k, w), dtype=torch.int32,
                       device=windows[0].device)
    lo = 0
    while windows:
        b = windows.pop(0)
        send[lo:lo + int(b.shape[0])] = b
        lo += int(b.shape[0])
        del b
    got = mesh.all_to_all(send.view(D, -1)).view(D, k, w)
    del send
    lo, hi = Share(D, mesh.rank, C, 1).cols
    return got[:, :hi - lo].permute(1, 0, 2).reshape(hi - lo, D * w)


def commit_windows(mesh: Mesh, windows: list, n: int, s: int) -> tuple:
    """Commit a (C, 2^n) natural-order size group on the 2^s domain over
    ``mesh`` from each rank's (C, 2^n/D) natural-order row window
    (``windows``, as `gather_share` takes it; step 0, then steps 1-7):
    what `commit_group` returns for the whole matrix."""
    C = sum(int(b.shape[0]) for b in windows)
    if not shards_rows(mesh, 1 << n) or \
            int(windows[0].shape[1]) * mesh.size != 1 << n:
        raise ValueError(f"windows of {int(windows[0].shape[1])} rows "
                         f"are not a split of 2^{n} over {mesh.size} ranks")
    with scope("mesh_exchange"), scope("mesh_share"):
        parts = [gather_share(mesh, windows)]
    return _commit_share(mesh, parts, C, n, s, True)


def commit_window(mesh: Mesh, ev: torch.Tensor) -> merkle.MerkleTree:
    """Steps 4-7 on this rank's (C, w) window of a (C, D·w)
    committed-order matrix (a view is read in place): the tree of the
    whole matrix as this rank holds it."""
    D, w = mesh.size, int(ev.shape[1])
    d, top = _log2(D * w), _log2(D)
    with scope("mesh_leaves"):
        sub = [blake2s.hash_rows(ev.t())]
    with scope("mesh_climb"):
        while sub[-1].shape[0] > 1:
            sub.append(blake2s.hash_parents(sub[-1]))
    layers: list = [None] * (d + 1)
    for j, x in enumerate(sub[:-1]):
        layers[d - j] = x
    with scope("mesh_exchange"):
        layers[top] = mesh.all_gather(sub[-1]).contiguous()
    with scope("mesh_climb"):
        for dd in range(top - 1, -1, -1):
            layers[dd] = blake2s.hash_parents(layers[dd + 1])
    lo = mesh.rank * w
    return merkle.MerkleTree(layers=layers, columns=[], matrix=ev,
                             window=(lo, lo + w), top=top)


def _columns(mesh: Mesh, columns) -> torch.Tensor:
    return (from_u32(columns, mesh.device) if isinstance(columns, np.ndarray)
            else columns.to(device=mesh.device, dtype=torch.int32))


def sharded_lde(mesh: Mesh, columns, trace_log: int,
                eval_log: int) -> torch.Tensor:
    """(C, 2^trace_log) natural-order columns -> their (C, 2^eval_log)
    committed-order evaluations, each rank transforming its share of the
    columns; every rank gets the whole matrix."""
    mat = _columns(mesh, columns)
    C = int(mat.shape[0])
    sh = Share(mesh.size, mesh.rank, C, 1 << eval_log)
    lo, hi = sh.cols
    with scope("mesh_lde"):
        ev = torch.zeros((sh.k, 1 << eval_log), dtype=torch.int32,
                         device=mat.device)
        if hi > lo:
            ev[:hi - lo] = _lde(mat[lo:hi], trace_log, eval_log, True)[1]
    with scope("mesh_exchange"):
        return mesh.all_gather(ev)[:C]


def sharded_commit_columns(mesh: Mesh, columns, trace_log: int,
                           log_blowup: int) -> tuple:
    """Shard-parallel commit of equal-size columns: (C, 2^trace_log)
    natural order (numpy uint32 or an int32 tensor).  Returns (the whole
    committed evaluations (C, M) on the mesh's device, root (8,) numpy
    uint32), the values of the single-process ``pcs`` commit: the rank
    windows gathered.  C need not divide by the mesh's size; M too
    small to split is committed whole on every rank."""
    mat = _columns(mesh, columns)
    s = trace_log + log_blowup
    if not shards_rows(mesh, 1 << s):
        ev = _lde(mat, trace_log, s, True)[1]
        return ev, merkle.commit_matrix(ev).root()
    _cf, ev, tree = commit_group(mesh, mat, trace_log, s)
    C, w = ev.shape
    with scope("mesh_exchange"):
        whole = mesh.gather_flat(ev.reshape(-1)).to(ev.device) \
            .view(mesh.size, C, w).transpose(0, 1).reshape(C, -1)
    return whole, tree.root()

"""Blake2s Merkle trees over power-of-two column sets.

A column of size 2^d is injected at depth d: the node at depth d hashes
``left(8 words) || right(8 words) || column values at d``, and the
deepest layer hashes the column values alone.  Uniform trees
(:func:`commit_matrix`) keep their columns as one (C, 2^d) matrix; leaf
hashing reads its transpose in place and every parent layer is one
launch of the parent kernel (both kernel K2).

A column-streamed tree (``prover/pcs.py``) has its leaf digests but no
matrix: :func:`tree_from_leaves` climbs it, and its openings take the
(C, Q) values from the caller.

Openings gather on the device into one buffer for all trees (kernel K9,
``csrc/gather.cu``; plain indexing on the CPU) and reach the host in one
transfer (:func:`finalize_decommitments`); the verifier is host
numpy/hashlib.

Under a mesh (``parallel/commit.py``) a rank's tree holds the row window
``window`` of its leaves, the layers below the top over that window and
the top ``top`` layers whole.  A position p of a 2^d-leaf tree lives on
rank p // (2^d / D), with its sibling p ^ 1; each rank gathers the
values and below-top siblings of the positions it owns into their
places of the proof's buffer (rank 0 the top's siblings and every whole
tree's words), and one disjoint sum over the ranks completes it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from .blake2s import hash_rows, hash_parents
from ..utils.device import to_u32, upload_i64

__all__ = ["MerkleTree", "commit", "commit_matrix", "tree_from_leaves",
           "MerkleDecommitment", "decommit", "decommit_many_fused",
           "gather_columns", "gather_plan", "gather_magic", "gather_tables",
           "gather_launch", "gather_openings", "gather_openings_plain",
           "finalize_decommitments", "verify_decommitment"]


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    assert 1 << k == n, "column sizes must be powers of two"
    return k


@dataclass
class MerkleTree:
    """layers[d] is the (2^d, 8) digest tensor at depth d; on a mesh
    rank (``window`` set) the rows of its window below depth ``top``."""
    layers: list
    columns: list          # committed columns (mixed-depth trees)
    matrix: object = None  # (C, 2^max_depth) tensor for uniform trees;
                           # the (C, hi - lo) window on a mesh rank
    window: tuple = None   # leaf rows [lo, hi) a mesh rank holds
    top: int = 0           # depths 0..top held whole (a mesh rank)

    @property
    def max_depth(self) -> int:
        return len(self.layers) - 1

    @property
    def sharded(self) -> bool:
        """Committed over a mesh, its rows in windows."""
        return self.window is not None

    def root(self) -> np.ndarray:
        return to_u32(self.layers[0][0])


def commit_matrix(matrix: torch.Tensor) -> MerkleTree:
    """Uniform-depth commit of the rows of a (C, 2^d) matrix; equal to
    ``commit([matrix[0], ..., matrix[C - 1]])``."""
    return tree_from_leaves(hash_rows(matrix.t()), matrix)


def tree_from_leaves(leaves: torch.Tensor, matrix=None) -> MerkleTree:
    """Uniform tree over (2^d, 8) leaf digests: every parent layer up
    to the root.  ``matrix`` is None for a streamed commitment, whose
    openings then take their values from the caller."""
    d = _log2(leaves.shape[0])
    layers: list = [None] * (d + 1)
    layers[d] = leaves
    for dd in range(d - 1, -1, -1):
        layers[dd] = hash_parents(layers[dd + 1])
    return MerkleTree(layers=layers, columns=[], matrix=matrix)


def commit(columns) -> MerkleTree:
    """Commit to a list of power-of-two-sized int32 column tensors."""
    assert columns, "cannot commit to zero columns"
    if all(c.shape[0] == columns[0].shape[0] for c in columns):
        return commit_matrix(torch.stack(list(columns)))
    by_depth: dict = {}
    for i, col in enumerate(columns):
        by_depth.setdefault(_log2(col.shape[0]), []).append(i)
    max_depth = max(by_depth)
    layers: list = [None] * (max_depth + 1)
    below = None
    for d in range(max_depth, -1, -1):
        parts = [] if below is None else [below.reshape(1 << d, 16)]
        parts += [columns[ci][:, None] for ci in by_depth.get(d, ())]
        msg = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        below = hash_rows(msg)
        layers[d] = below
    return MerkleTree(layers=layers, columns=list(columns))


@dataclass
class MerkleDecommitment:
    """column_values: per committed column, the values at the queried
    positions of its own depth; sibling_hashes: off-path digests,
    bottom-up, left to right."""
    column_values: list = field(default_factory=list)
    sibling_hashes: list = field(default_factory=list)


def _positions_at(queries, max_depth, d):
    return sorted({q >> (max_depth - d) for q in queries})


def open_plan(max_depth: int, positions):
    """Per depth (bottom-up) the sibling positions in the order the
    verifier consumes them."""
    sib_positions = []
    pos = positions
    for _d in range(max_depth, 0, -1):
        ps = set(pos)
        sib_positions.append([p ^ 1 for p in pos if (p ^ 1) not in ps])
        pos = sorted({p >> 1 for p in pos})
    return sib_positions


@dataclass
class _Gather:
    """One piece of the opening gather: buf[out + (r * n + i) * W + t]
    = src[r, idx[i]] (W == 1) or src[idx[i], t] (a digest layer)."""
    src: torch.Tensor          # (rows, 2^d) values or (2^d, 8) digests
    idx: np.ndarray            # (n,) int64
    width: int                 # W: 1 for values, 8 for digests
    out: int = 0               # the piece's first word in the buffer

    @property
    def rows(self) -> int:
        return int(self.src.shape[0]) if self.width == 1 else 1

    @property
    def words(self) -> int:
        return self.rows * len(self.idx) * self.width

    def shape(self):
        return ((self.rows, len(self.idx)) if self.width == 1
                else (len(self.idx), self.width))

    def plain(self) -> torch.Tensor:
        ix = torch.as_tensor(self.idx, device=self.src.device)
        return self.src[:, ix] if self.width == 1 else self.src[ix]


def _idx(positions) -> np.ndarray:
    return np.asarray(positions, dtype=np.int64).reshape(-1)


def place(pieces, base: int = 0) -> int:
    """Put ``pieces`` one after another from word ``base`` of the
    buffer (each piece's ``out``); returns the word after the last."""
    for p in pieces:
        p.out = base
        base += p.words
    return base


def _end(pieces) -> int:
    """The word after the last piece."""
    return max((p.out + p.words for p in pieces), default=0)


def _pieces(tree: MerkleTree, queries, values=None, base: int = 0):
    """(values pieces, digest pieces) of one opening, placed one after
    another from word ``base``; ``values``: the (C, Q) opened values of
    a tree without a matrix (a streamed one), at the sorted distinct
    queries."""
    queries = sorted(set(int(q) for q in queries))
    if values is not None:
        if values.dim() != 2 or values.shape[1] != len(queries):
            raise ValueError(f"values {tuple(values.shape)} for "
                             f"{len(queries)} positions")
        vals = [_Gather(values, np.arange(len(queries), dtype=np.int64),
                        1)]
    elif tree.matrix is not None:
        vals = [_Gather(tree.matrix, _idx(queries), 1)]
    elif not tree.columns:
        raise ValueError("a tree without columns opens with given values")
    else:
        vals = [_Gather(col[None, :], _idx(_positions_at(
                    queries, tree.max_depth, _log2(col.shape[0]))), 1)
                for col in tree.columns]
    sibs = [_Gather(tree.layers[d], _idx(s), 8)
            for d, s in zip(range(tree.max_depth, 0, -1),
                            open_plan(tree.max_depth, queries)) if s]
    place(vals + sibs, base)
    return vals, sibs


class PendingOpenings:
    """Openings gathered on the device into one int32 buffer; finalize
    them with :func:`finalize_decommitments`."""

    def __init__(self, buffer, layout):
        self.buffer = buffer       # (words,) int32, or None
        self.layout = layout       # per opening: (value shapes, digest shapes)


def gather_openings_plain(pieces, words: int | None = None) -> torch.Tensor:
    """A buffer of ``words`` words (by default up to the last piece's
    end), each piece's words at its ``out`` (plain indexing), zero where
    no piece writes."""
    buf = torch.zeros(_end(pieces) if words is None else words,
                      dtype=torch.int32, device=pieces[0].src.device)
    for p in pieces:
        buf[p.out:p.out + p.words] = p.plain().reshape(-1)
    return buf


# K9's work partition (`gather_plan`, mirrored by csrc/gather.cu): a
# unit is at most GATHER_UNIT output words of one piece (kThreads x kPer
# of the kernel), one block each
GATHER_UNIT = 1024
# descriptor fields of a piece, int64 each (the D_* of csrc/gather.cu)
GATHER_FIELDS = ("src", "out", "idx", "n", "wlog", "rows", "rs", "is", "ts",
                 "magic", "shift", "vec")
# the kernel's words and indices are 31-bit
GATHER_LIMIT = 1 << 31
_POW2 = 1 << np.arange(32, dtype=np.int64)


def gather_magic(n):
    """(magic, shift) with (p * magic) >> shift == p // n for every p <
    2^31 and 1 <= n <= 2^31 (magic < 2^32): shift = 31 + ceil(log2 n),
    magic = ceil(2^shift / n)."""
    n = np.asarray(n, dtype=np.int64)
    shift = 31 + np.searchsorted(_POW2, n)
    return ((np.int64(1) << shift) + n - 1) // n, shift


def gather_plan(pieces, unit: int = GATHER_UNIT, words: int | None = None):
    """K9's tables for ``pieces`` in a buffer of ``words`` words (by
    default up to the last piece's end), packed into one int64 array:
    the (G, len(GATHER_FIELDS)) descriptors, a piece each in order
    ("out" its ``out``, "idx" the running offset of its indices; "vec"
    1 for a digest piece whose rows are 16-byte aligned), then the unit
    table, (piece << 32) | first word for every ``unit`` words of each
    piece, then every piece's indices.  Returns (packed, G, units,
    words).  Raises on sources that are not int32 matrices on one
    device, a gather of 2^31 words or more, a width that is not a power
    of two up to 8, an index outside its source, or pieces that overlap
    or end past ``words``."""
    f = {name: i for i, name in enumerate(GATHER_FIELDS)}
    geo = []
    for p in pieces:
        t = p.src
        st = t.stride()
        if t.dtype is not torch.int32 or len(st) != 2:
            raise ValueError(f"opening source {t.dtype} {tuple(t.shape)}: "
                             f"expected an int32 matrix")
        (s0, s1), (d0, d1) = st, t.shape
        geo.append((t.data_ptr(), t.get_device(), len(p.idx), 1, d0, s0, s1,
                    0, d1) if p.width == 1 else
                   (t.data_ptr(), t.get_device(), len(p.idx), p.width, 1, 0,
                    s0, s1, d0))
    geo = np.array(geo, dtype=np.int64).reshape(-1, 9)
    src, on, n, W, rows, rs, is_, ts, dim = geo.T
    if (on != on[:1]).any():
        raise ValueError("opening sources on more than one device")
    sizes = rows * n * W
    out = np.array([p.out for p in pieces], dtype=np.int64)
    total = _end(pieces) if words is None else int(words)
    order = np.argsort(out, kind="stable")
    if ((out < 0) | (out + sizes > total)).any() or \
            (out[order][1:] < (out + sizes)[order][:-1]).any():
        raise ValueError(f"pieces that overlap or lie outside the buffer "
                         f"of {total} words")
    if total >= GATHER_LIMIT:
        raise ValueError(f"a gather of {total} words: the kernel takes "
                         f"fewer than 2^31")
    wlog = np.searchsorted(_POW2, W)
    if (W > 8).any() or (_POW2[wlog] != W).any():
        raise ValueError(f"piece widths {sorted(set(W.tolist()))}: the "
                         f"kernel takes 1, 2, 4 or 8")
    idx = (np.concatenate([p.idx for p in pieces]) if pieces
           else np.zeros(0, np.int64))
    lim = np.repeat(np.minimum(dim, GATHER_LIMIT), n)
    if ((idx < 0) | (idx >= lim)).any():
        raise ValueError("an opening index outside its source")
    table = np.zeros((len(pieces), len(GATHER_FIELDS)), np.int64)
    magic, shift = gather_magic(np.maximum(n, 1))
    vec = (W == 8) & (ts == 1) & (src % 16 == 0) & (is_ % 4 == 0) & \
        ((rows == 1) | (rs % 4 == 0))
    for name, col in (("src", src), ("out", out),
                      ("idx", np.cumsum(n) - n), ("n", n), ("wlog", wlog),
                      ("rows", rows), ("rs", rs), ("is", is_), ("ts", ts),
                      ("magic", magic), ("shift", shift), ("vec", vec)):
        table[:, f[name]] = col
    per = -(-sizes // unit)
    first = np.arange(int(per.sum()), dtype=np.int64) - \
        np.repeat(np.cumsum(per) - per, per)
    units = (np.repeat(np.arange(len(pieces), dtype=np.int64), per) << 32) \
        | (first * unit)
    return (np.concatenate([table.reshape(-1), units, idx]), len(pieces),
            len(units), total)


def gather_tables(pieces, words: int | None = None):
    """K9's inputs for CUDA pieces: `gather_plan`'s packed tables on
    the pieces' card in one copy (`utils.device.upload_i64`), their
    descriptor and unit counts, the buffer's word count and whether the
    pieces leave words of it unwritten."""
    src = pieces[0].src
    kernels.check_cuda_tensor(src, "opening source", ndim=2,
                              contiguous=False)
    packed, G, U, words = gather_plan(pieces, words=words)
    gaps = sum(p.words for p in pieces) < words
    return upload_i64(packed, src.device), G, U, words, gaps


def gather_launch(buf, n_desc: int, n_units: int, words: int,
                  zero: bool) -> torch.Tensor:
    """Launch ``csrc/gather.cu`` (kernel K9) on the tables of
    :func:`gather_tables`: the (words,) int32 buffer, zero first where
    the pieces leave gaps (``zero``)."""
    kernels.check_cuda_tensor(buf, "gather tables", ndim=1, dtype=torch.int64)
    out = (torch.zeros if zero else torch.empty)(
        words, dtype=torch.int32, device=buf.device)
    if n_units:
        kernels.launch("gather_openings", buf.data_ptr(), n_desc, n_units,
                       out.data_ptr(), device=buf.device)
    return out


def gather_openings(pieces, words: int | None = None) -> torch.Tensor:
    """One int32 buffer of ``words`` words (by default up to the last
    piece's end), each piece's words at its ``out``, zero where no piece
    writes: launches kernel K9 on CUDA sources, plain indexing on CPU
    ones."""
    dev = pieces[0].src.device
    if pieces[0].src.is_cuda:
        return gather_launch(*gather_tables(pieces, words))
    if dev.type == "cpu":
        return gather_openings_plain(pieces, words)
    raise ValueError(f"unsupported device {dev}")


def gather_columns(src: torch.Tensor, idx) -> torch.Tensor:
    """(rows, n) = src[:, idx] of a (rows, N) matrix at n indices: a host
    sequence, or an int64 tensor on src's device (each index below N),
    which a caller gathering many chunks at the same positions uploads
    once.  On CUDA one K9 launch through its single-piece entry, no
    table copy; on the CPU plain indexing."""
    if not src.is_cuda:
        if src.device.type != "cpu":
            raise ValueError(f"unsupported device {src.device}")
        ix = _idx(idx.numpy() if isinstance(idx, torch.Tensor) else idx)
        return gather_openings_plain([_Gather(src, ix, 1)]).reshape(
            int(src.shape[0]), len(ix))
    kernels.check_cuda_tensor(src, "columns", ndim=2, contiguous=False)
    if not isinstance(idx, torch.Tensor):
        ix = _idx(idx)
        if ((ix < 0) | (ix >= int(src.shape[1]))).any():
            raise ValueError("a column index outside the source")
        idx = upload_i64(ix, src.device)
    kernels.check_cuda_tensor(idx, "column indices", ndim=1,
                              dtype=torch.int64)
    if idx.device != src.device:
        raise ValueError(f"indices on {idx.device}, columns on {src.device}")
    rows, n = int(src.shape[0]), int(idx.shape[0])
    if rows * n >= GATHER_LIMIT or int(src.shape[1]) > GATHER_LIMIT:
        raise ValueError(f"a gather of ({rows}, {n}) words from "
                         f"{tuple(src.shape)}: the kernel takes fewer than "
                         f"2^31 words and indices")
    out = torch.empty((rows, n), dtype=torch.int32, device=src.device)
    if rows and n:
        kernels.launch("gather_openings", src.data_ptr(), rows, src.stride(0),
                       src.stride(1), idx.data_ptr(), n, out.data_ptr(),
                       device=src.device, entry="nzt_gather_columns")
    return out


def _mesh_pieces(tree: MerkleTree, queries, rank: int, base: int):
    """One opening on a mesh rank, its words from ``base`` of the
    proof's buffer: (value shapes, digest shapes, the pieces this rank
    gathers, each at its place, words).  A windowed tree: the values and
    below-top siblings of the positions in this rank's window (a value
    piece a column, at its run of positions); rank 0: the top's siblings,
    and all of a whole tree."""
    queries = sorted(set(int(q) for q in queries))
    plan = open_plan(tree.max_depth, queries)
    C, Q = int(tree.matrix.shape[0]), len(queries)
    shapes = ([(C, Q)], [(len(s), 8) for s in plan if s])
    words = C * Q + 8 * sum(len(s) for s in plan)
    mine = []
    if tree.window is None:
        if rank == 0:
            vals, sibs = _pieces(tree, queries, base=base)
            mine = vals + sibs
        return (*shapes, mine, words)
    lo, hi = tree.window

    def run(pos, a, b):
        """[i0, i1) of the sorted ``pos`` that lie in [a, b)."""
        return (int(np.searchsorted(pos, a)), int(np.searchsorted(pos, b)))
    i0, i1 = run(queries, lo, hi)
    if i1 > i0:
        idx = _idx(queries[i0:i1]) - lo
        mine += [_Gather(tree.matrix[c:c + 1], idx, 1, out=base + c * Q + i0)
                 for c in range(C)]
    off = base + C * Q
    for d, s in zip(range(tree.max_depth, 0, -1), plan):
        if not s:
            continue
        if d > tree.top:
            sh = tree.max_depth - d
            j0, j1 = run(s, lo >> sh, hi >> sh)
            if j1 > j0:
                mine.append(_Gather(tree.layers[d], _idx(s[j0:j1]) -
                                    (lo >> sh), 8, out=off + 8 * j0))
        elif rank == 0:
            mine.append(_Gather(tree.layers[d], _idx(s), 8, out=off))
        off += 8 * len(s)
    return (*shapes, mine, words)


def decommit_many_fused(items, mesh=None) -> PendingOpenings:
    """Gather the openings of many (tree, positions) pairs in one
    launch, or (tree, positions, values) for a streamed tree; finalize
    them together with :func:`finalize_decommitments`.  Under ``mesh``
    (two or more ranks; no streamed tree) each rank gathers its part of
    every opening into its places (`_mesh_pieces`) and the disjoint sum
    over the ranks is the buffer, the same on every rank."""
    if mesh is not None and mesh.size > 1:
        pieces, layout, words = [], [], 0
        for tree, queries in items:
            vals, sibs, mine, n = _mesh_pieces(tree, queries, mesh.rank,
                                               words)
            pieces += mine
            layout.append((vals, sibs))
            words += n
        buf = (gather_openings(pieces, words) if pieces else
               torch.zeros(words, dtype=torch.int32, device=mesh.device))
        return PendingOpenings(mesh.all_reduce(buf), layout)
    pieces, layout = [], []
    for item in items:
        vals, sibs = _pieces(*item, base=_end(pieces))
        pieces += vals + sibs
        layout.append(([p.shape() for p in vals], [p.shape() for p in sibs]))
    return PendingOpenings(gather_openings(pieces) if pieces else None,
                           layout)


def finalize_decommitments(pending: PendingOpenings) -> list:
    """Bring every pending opening to the host in one transfer."""
    host = (to_u32(pending.buffer) if pending.buffer is not None
            else np.zeros(0, np.uint32))
    out, k = [], 0

    def take(shape):
        nonlocal k
        n = int(np.prod(shape))
        arr = host[k:k + n].reshape(shape)
        k += n
        return arr

    for val_shapes, sib_shapes in pending.layout:
        dec = MerkleDecommitment()
        for shape in val_shapes:
            vals = take(shape)
            dec.column_values.extend(vals[c] for c in range(shape[0]))
        for shape in sib_shapes:
            dec.sibling_hashes.extend(take(shape))
        out.append(dec)
    return out


def decommit(tree: MerkleTree, queries) -> MerkleDecommitment:
    return finalize_decommitments(decommit_many_fused([(tree, queries)]))[0]


def _verify_decommitment_uniform(root, depth: int, n_cols: int, queries,
                                 dec: MerkleDecommitment) -> bool:
    pos = sorted(set(int(q) for q in queries))
    if len(dec.column_values) != n_cols or n_cols == 0:
        return False
    for cv in dec.column_values:
        if len(cv) != len(pos):
            return False
    vals = np.ascontiguousarray(
        np.stack([np.asarray(cv, dtype="<u4") for cv in dec.column_values],
                 axis=1))
    cur = {p: hashlib.blake2s(vals[i].tobytes()).digest()
           for i, p in enumerate(pos)}
    sib_iter = iter(dec.sibling_hashes)
    for _d in range(depth, 0, -1):
        for p in list(cur):
            s = p ^ 1
            if s not in cur:
                try:
                    cur[s] = np.asarray(next(sib_iter), dtype="<u4").tobytes()
                except StopIteration:
                    return False
        parents = sorted({p >> 1 for p in pos})
        cur = {pp: hashlib.blake2s(cur[2 * pp] + cur[2 * pp + 1]).digest()
               for pp in parents}
        pos = parents
    return cur[0] == np.asarray(root, dtype="<u4").tobytes()


def verify_decommitment(root, column_lengths, queries,
                        decommitment: MerkleDecommitment) -> bool:
    """Recompute the root from a decommitment (host).  column_lengths:
    sizes of the committed columns in commit order."""
    if column_lengths and all(n == column_lengths[0]
                              for n in column_lengths):
        return _verify_decommitment_uniform(
            root, _log2(column_lengths[0]), len(column_lengths), queries,
            decommitment)
    queries = sorted(set(int(q) for q in queries))
    max_depth = max(_log2(n) for n in column_lengths)
    by_depth: dict = {}
    for i, n in enumerate(column_lengths):
        by_depth.setdefault(_log2(n), []).append(i)
    vals: dict = {}
    for i, n in enumerate(column_lengths):
        pos = _positions_at(queries, max_depth, _log2(n))
        got = decommitment.column_values[i]
        if len(got) != len(pos):
            return False
        for p, v in zip(pos, got):
            vals[(i, p)] = int(v)
    sib_iter = iter(decommitment.sibling_hashes)
    cur: dict = {}
    pos = queries
    for d in range(max_depth, -1, -1):
        nxt: dict = {}
        new_pos = sorted({p >> 1 for p in pos}) if d > 0 else []
        for p in pos:
            msg = b""
            if d < max_depth:
                msg += cur[2 * p] + cur[2 * p + 1]
            for ci in by_depth.get(d, ()):
                msg += int(vals[(ci, p)]).to_bytes(4, "little")
            nxt[p] = hashlib.blake2s(msg).digest()
        if d == 0:
            return nxt[0] == np.asarray(root, dtype="<u4").tobytes()
        pos_set = set(pos)
        full = dict(nxt)
        for p in pos:
            if (p ^ 1) not in pos_set:
                try:
                    full[p ^ 1] = np.asarray(next(sib_iter),
                                             dtype="<u4").tobytes()
                except StopIteration:
                    return False
        cur = full
        pos = new_pos
    return False

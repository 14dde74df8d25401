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
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from .blake2s import hash_rows, hash_parents
from ..utils.device import to_u32

__all__ = ["MerkleTree", "commit", "commit_matrix", "tree_from_leaves",
           "MerkleDecommitment", "decommit", "decommit_many_fused",
           "gather_columns", "gather_tables", "gather_launch",
           "gather_openings", "gather_openings_plain",
           "finalize_decommitments", "verify_decommitment"]


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    assert 1 << k == n, "column sizes must be powers of two"
    return k


@dataclass
class MerkleTree:
    """layers[d] is the (2^d, 8) digest tensor at depth d."""
    layers: list
    columns: list          # committed columns (mixed-depth trees)
    matrix: object = None  # (C, 2^max_depth) tensor for uniform trees
    sharded: bool = False  # committed over a mesh (parallel/commit.py)

    @property
    def max_depth(self) -> int:
        return len(self.layers) - 1

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
    """One piece of the opening gather: out[(r * n + i) * W + t] =
    src[r, idx[i]] (W == 1) or src[idx[i], t] (a digest layer)."""
    src: torch.Tensor          # (rows, 2^d) values or (2^d, 8) digests
    idx: list
    width: int                 # W: 1 for values, 8 for digests

    @property
    def rows(self) -> int:
        return int(self.src.shape[0]) if self.width == 1 else 1

    @property
    def words(self) -> int:
        return self.rows * len(self.idx) * self.width

    def shape(self):
        return ((self.rows, len(self.idx)) if self.width == 1
                else (len(self.idx), self.width))

    def descriptor(self, out_off: int, idx_off: int) -> list:
        if self.width == 1:
            rs, is_, ts = self.src.stride(0), self.src.stride(1), 0
        else:
            rs, is_, ts = 0, self.src.stride(0), self.src.stride(1)
        return [self.src.data_ptr(), out_off, idx_off, len(self.idx),
                self.width, self.rows, rs, is_, ts]

    def plain(self) -> torch.Tensor:
        ix = torch.as_tensor(self.idx, device=self.src.device)
        return self.src[:, ix] if self.width == 1 else self.src[ix]


def _pieces(tree: MerkleTree, queries, values=None):
    """(values pieces, digest pieces) of one opening; ``values``: the
    (C, Q) opened values of a tree without a matrix (a streamed one), at
    the sorted distinct queries."""
    queries = sorted(set(int(q) for q in queries))
    if values is not None:
        if values.dim() != 2 or values.shape[1] != len(queries):
            raise ValueError(f"values {tuple(values.shape)} for "
                             f"{len(queries)} positions")
        vals = [_Gather(values, list(range(len(queries))), 1)]
    elif tree.matrix is not None:
        vals = [_Gather(tree.matrix, queries, 1)]
    elif not tree.columns:
        raise ValueError("a tree without columns opens with given values")
    else:
        vals = [_Gather(col[None, :], _positions_at(
                    queries, tree.max_depth, _log2(col.shape[0])), 1)
                for col in tree.columns]
    sibs = [_Gather(tree.layers[d], s, 8)
            for d, s in zip(range(tree.max_depth, 0, -1),
                            open_plan(tree.max_depth, queries)) if s]
    return vals, sibs


class PendingOpenings:
    """Openings gathered on the device into one int32 buffer; finalize
    them with :func:`finalize_decommitments`."""

    def __init__(self, buffer, layout):
        self.buffer = buffer       # (words,) int32, or None
        self.layout = layout       # per opening: (value shapes, digest shapes)


def gather_openings_plain(pieces) -> torch.Tensor:
    """The pieces' words, concatenated (plain indexing)."""
    return torch.cat([p.plain().reshape(-1) for p in pieces])


def gather_tables(pieces):
    """K9's inputs for CUDA pieces: the (n, 9) descriptor table and the
    index list on the pieces' device, and the buffer's word count."""
    desc, idx, off = [], [], 0
    for p in pieces:
        kernels.check_cuda_tensor(p.src, "opening source", ndim=2,
                                  contiguous=False)
        desc.append(p.descriptor(off, len(idx)))
        idx += p.idx
        off += p.words
    dev = pieces[0].src.device
    return (torch.tensor(desc, dtype=torch.int64).to(dev),
            torch.tensor(idx, dtype=torch.int64).to(dev), off)


def gather_launch(desc, idx, words: int) -> torch.Tensor:
    """Launch ``csrc/gather.cu`` (kernel K9) on the tables of
    :func:`gather_tables`: the (words,) int32 buffer."""
    kernels.check_cuda_tensor(desc, "descriptors", ndim=2, dtype=torch.int64)
    kernels.check_cuda_tensor(idx, "indices", ndim=1, dtype=torch.int64)
    if desc.shape[1] != 9:
        raise ValueError("descriptors must be (n, 9)")
    out = torch.empty(words, dtype=torch.int32, device=desc.device)
    kernels.launch("gather_openings", desc.data_ptr(), int(desc.shape[0]),
                   idx.data_ptr(), out.data_ptr(), device=desc.device)
    return out


def gather_openings(pieces) -> torch.Tensor:
    """One int32 buffer of every piece's words: launches kernel K9 on
    CUDA sources, plain indexing on CPU ones."""
    dev = pieces[0].src.device
    if pieces[0].src.is_cuda:
        return gather_launch(*gather_tables(pieces))
    if dev.type == "cpu":
        return gather_openings_plain(pieces)
    raise ValueError(f"unsupported device {dev}")


def gather_columns(src: torch.Tensor, idx) -> torch.Tensor:
    """(rows, len(idx)) = src[:, idx] of a (rows, N) matrix: one K9
    launch on CUDA, plain indexing on the CPU."""
    return gather_openings([_Gather(src, list(idx), 1)]).reshape(
        int(src.shape[0]), len(idx))


def decommit_many_fused(items) -> PendingOpenings:
    """Gather the openings of many (tree, positions) pairs in one
    launch, or (tree, positions, values) for a streamed tree; finalize
    them together with :func:`finalize_decommitments`."""
    pieces, layout = [], []
    for item in items:
        vals, sibs = _pieces(*item)
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

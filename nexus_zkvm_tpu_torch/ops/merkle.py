"""Blake2s Merkle trees over power-of-two column sets.

A column of size 2^d is injected at depth d: the node at depth d hashes
``left(8 words) || right(8 words) || column values at d``, and the
deepest layer hashes the column values alone.  Uniform trees
(:func:`commit_matrix`) keep their columns as one (C, 2^d) matrix; leaf
hashing reads its transpose in place and every parent layer is one
launch of the parent kernel (both kernel K2).

Openings gather on the device (plain indexing) and reach the host in
one transfer for all trees (:func:`finalize_decommitments`); the
verifier is host numpy/hashlib.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .blake2s import hash_rows, hash_parents
from ..utils.device import to_u32

__all__ = ["MerkleTree", "commit", "commit_matrix", "MerkleDecommitment",
           "decommit", "decommit_async", "decommit_many_fused",
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

    @property
    def max_depth(self) -> int:
        return len(self.layers) - 1

    def root(self) -> np.ndarray:
        return to_u32(self.layers[0][0])


def commit_matrix(matrix: torch.Tensor) -> MerkleTree:
    """Uniform-depth commit of the rows of a (C, 2^d) matrix; equal to
    ``commit([matrix[0], ..., matrix[C - 1]])``."""
    C, n = matrix.shape
    d = _log2(n)
    layers: list = [None] * (d + 1)
    layers[d] = hash_rows(matrix.t())
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


class PendingDecommitment:
    """An opening whose gathers were issued on the device; finalize many
    of them together with :func:`finalize_decommitments`."""

    def __init__(self, vals, col_vals, sib_rows):
        self._vals = vals            # (C, Q) tensor or None
        self._col_vals = col_vals    # [(Qc,) tensor] for mixed trees
        self._sib_rows = sib_rows    # [(K_d, 8) tensor]

    def tensors(self):
        head = [] if self._vals is None else [self._vals]
        return head + self._col_vals + self._sib_rows

    def finalize(self, fetched) -> MerkleDecommitment:
        fetched = list(fetched)
        out = MerkleDecommitment()
        if self._vals is not None:
            vals = fetched.pop(0)
            out.column_values.extend(vals[c] for c in range(vals.shape[0]))
        for _ in self._col_vals:
            out.column_values.append(fetched.pop(0))
        for _ in self._sib_rows:
            out.sibling_hashes.extend(fetched.pop(0))
        return out


def decommit_async(tree: MerkleTree, queries) -> PendingDecommitment:
    queries = sorted(set(int(q) for q in queries))
    dev = tree.layers[0].device
    vals, col_vals = None, []
    if tree.matrix is not None:
        vals = tree.matrix[:, torch.as_tensor(queries, device=dev)]
    else:
        for col in tree.columns:
            pos = _positions_at(queries, tree.max_depth, _log2(col.shape[0]))
            col_vals.append(col[torch.as_tensor(pos, device=dev)])
    sib_rows = [tree.layers[d][torch.as_tensor(sibs, device=dev)]
                for d, sibs in zip(range(tree.max_depth, 0, -1),
                                   open_plan(tree.max_depth, queries))
                if sibs]
    return PendingDecommitment(vals, col_vals, sib_rows)


def decommit_many_fused(items):
    """Issue the gathers of many openings, items being (tree, positions)
    pairs; finalize them together with :func:`finalize_decommitments`."""
    return [decommit_async(tree, pos) for tree, pos in items]


def finalize_decommitments(pendings) -> list:
    """Bring every pending opening to the host in one transfer."""
    flat = [t for p in pendings for t in p.tensors()]
    if not flat:
        return [p.finalize([]) for p in pendings]
    host = to_u32(torch.cat([t.reshape(-1) for t in flat]))
    arrays, k = [], 0
    for t in flat:
        arrays.append(host[k: k + t.numel()].reshape(tuple(t.shape)))
        k += t.numel()
    out, k = [], 0
    for p in pendings:
        n = len(p.tensors())
        out.append(p.finalize(arrays[k:k + n]))
        k += n
    return out


def decommit(tree: MerkleTree, queries) -> MerkleDecommitment:
    return finalize_decommitments([decommit_async(tree, queries)])[0]


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

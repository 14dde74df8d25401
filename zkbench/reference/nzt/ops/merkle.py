"""Checking openings of uniform Blake2s Merkle trees.

The deepest layer hashes each position's column values, every layer
above the 16 words of its two children; ``verify_decommitment`` climbs
a decommitment's values and siblings to the root with hashlib.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np


__all__ = ["MerkleDecommitment", "verify_decommitment"]


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    assert 1 << k == n, "column sizes must be powers of two"
    return k


@dataclass
class MerkleDecommitment:
    """column_values: per committed column, the values at the queried
    positions of its own depth; sibling_hashes: off-path digests,
    bottom-up, left to right."""
    column_values: list = field(default_factory=list)
    sibling_hashes: list = field(default_factory=list)


def _positions_at(queries, max_depth, d):
    return sorted({q >> (max_depth - d) for q in queries})


# K9's work partition (`gather_plan`, mirrored by csrc/gather.cu): a


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

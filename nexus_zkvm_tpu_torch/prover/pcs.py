"""Polynomial commitment scheme: LDE + Merkle trees per role.

One Merkle tree per (role, eval-domain size); committed order is the
bit-reversed layout.  Columns enter in natural row order, move to the
device once per size group as a (C, 2^n) int32 matrix, are interpolated
(K1), and each size group is evaluated on its blown-up domain (K1),
permuted to committed order and committed (K2).  Coefficients, committed
evaluations and every tree layer stay on the device.

The large-trace memory mode (:class:`MemoryConfig`, chosen by size): a
size group whose evaluations exceed ``stream_commit_bytes`` is committed
column-streamed (:func:`_stream_commit`): its LDE is computed a chunk of
columns at a time and absorbed into the leaf hashes (K1, then K10), so
the (C, 2^s) evaluations never exist at once and are not kept
(``evals[s]`` is None).  The quotients and the openings recompute them
from the coefficients, chunk by chunk (:func:`opened_values_streamed`).
A natural-order group above the threshold is interpolated a chunk of
columns at a time (:func:`_interpolate_big`), in place when the
commitment does not keep the natural values.

Under a mesh of two or more ranks (``mesh=``, which ``prove`` takes from
the active mesh) a resident size group is committed through
``parallel/commit.py``: each rank interpolates and evaluates its share
of the columns (K1), the coefficients and evaluations are gathered, and
each rank hashes its share of the rows (K2).  A group stays unsharded
when it has fewer columns than ranks, when its rows do not split over
the mesh, or when it is streamed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import blake2s, cfft, merkle
from ..ops.circle import (bit_reverse_indices, dev_bit_reverse,
                          dev_layout_to_natural, dev_natural_to_layout)
from ..parallel import commit as pcommit
from ..utils.device import from_u32, upload_i64
from .config import MemoryConfig

__all__ = ["RoleCommitment", "commit_columns", "commit_blocks",
           "commit_from_coeffs", "open_positions", "opened_values_streamed",
           "lde_natural"]


@dataclass
class RoleCommitment:
    role: str
    trace_logs: list          # per column, commit order within the role
    log_blowup: int
    coeff_batches: dict       # n -> (column index list, (Cn, 2^n) tensor)
    evals: dict               # eval_log -> (C, 2^s) committed order; None
                              # for a streamed size
    cols_by_size: dict        # eval_log -> [column indices]
    trees: dict               # eval_log -> MerkleTree
    natural: dict = None      # n -> (column index list, (Cn, 2^n) tensor)
    _roots: list = field(default=None, repr=False)

    def sizes_desc(self):
        return sorted(self.trees, reverse=True)

    def streamed(self, s: int) -> bool:
        return self.evals.get(s) is None

    def roots(self):
        if self._roots is None:
            self._roots = [(s, self.trees[s].root())
                           for s in self.sizes_desc()]
        return self._roots

    def mix_roots(self, channel):
        for _s, root in self.roots():
            channel.mix_u32s(root)

    def _row_index(self, batches, col_idxs):
        """The (Cn, 2^n) batch of the columns ``col_idxs`` (all of one
        size n), their rows in it (None: the whole batch in order) and
        n."""
        ns = {self.trace_logs[i] for i in col_idxs}
        assert len(ns) == 1
        n = ns.pop()
        idxs, batch = batches[n]
        rowmap = {ci: r for r, ci in enumerate(idxs)}
        sel = [rowmap[i] for i in col_idxs]
        return batch, None if sel == list(range(batch.shape[0])) else sel, n

    def _rows(self, batches, col_idxs):
        batch, sel, n = self._row_index(batches, col_idxs)
        if sel is None:
            return batch, n
        return batch[torch.as_tensor(sel, device=batch.device)], n

    def coeff_rows(self, col_idxs):
        """(len(col_idxs), 2^n) coefficient rows and their n."""
        return self._rows(self.coeff_batches, col_idxs)

    def coeff_row_index(self, col_idxs):
        """The coefficient batch holding ``col_idxs`` and their rows in
        it (None: all of it, in order), for reading them in place."""
        return self._row_index(self.coeff_batches, col_idxs)[:2]

    def natural_rows(self, col_idxs):
        return self._rows(self.natural, col_idxs)



def lde_natural(cols: torch.Tensor, ev_log: int, start: int, width: int,
                chunk_cols: int) -> torch.Tensor:
    """(C, width) evaluations of the (C, 2^n) coefficient rows at natural
    rows start, start + 1, .. (mod 2^ev_log) of the 2^ev_log domain: per
    chunk of ``chunk_cols`` columns the whole-domain LDE (K1), then a
    gather of the rows (a window past either end of the domain wraps).
    The output is allocated after the first chunk's LDE, so a single
    chunk never holds its zero-extended input beside it."""
    rows = torch.arange(start, start + width, device=cols.device) \
        % (1 << ev_log)
    idx = dev_natural_to_layout(ev_log, cols.device)[rows]
    out = None
    for lo in range(0, int(cols.shape[0]), chunk_cols):
        ev = cfft.evaluate(cols[lo:lo + chunk_cols], ev_log)
        if out is None:
            out = torch.empty((int(cols.shape[0]), width), dtype=torch.int32,
                              device=cols.device)
        torch.index_select(ev, 1, idx, out=out[lo:lo + chunk_cols])
        del ev
    return out


def _interpolate_big(dev: torch.Tensor, n: int, chunk_rows: int = 32,
                     in_place: bool = False) -> torch.Tensor:
    """Coefficients of a (C, 2^n) natural-order matrix, ``chunk_rows``
    columns at a time (K1 per chunk), so the working set beside the
    output is one chunk.  ``in_place``: each chunk's coefficients go back
    into the rows it was read from (the chunk is gathered to layout order
    first), so the natural matrix and the coefficients never coexist; the
    caller must not use ``dev`` afterwards."""
    out = dev if in_place else torch.empty_like(dev)
    l2n = dev_layout_to_natural(n, dev.device)
    for lo in range(0, int(dev.shape[0]), chunk_rows):
        cfft.interpolate(dev[lo:lo + chunk_rows][:, l2n],
                         out=out[lo:lo + chunk_rows])
    return out


def _stream_commit(batch: torch.Tensor, s: int,
                   chunk_cols: int) -> merkle.MerkleTree:
    """Column-streamed LDE + Merkle commit of a (C, 2^n) coefficient
    batch on the 2^s domain: per chunk of ``chunk_cols`` columns (a
    multiple of 16) the LDE (K1) is absorbed into the carried leaf states
    (K10), then the parents are climbed (K2).  Root and layers equal
    ``merkle.commit_matrix`` on the committed-order evaluations."""
    assert chunk_cols % 16 == 0, chunk_cols
    C = int(batch.shape[0])
    state, done = None, 0
    while done < C:
        c = min(chunk_cols, C - done)
        ev = cfft.evaluate(batch[done:done + c], s)
        state = blake2s.leaves_stream(state, ev, done, C, done + c == C)
        del ev
        done += c
    return merkle.tree_from_leaves(state)


def opened_values_streamed(rc: RoleCommitment, s: int, positions,
                           chunk_cols: int) -> torch.Tensor:
    """(C, Q) values of a streamed tree at the sorted distinct
    ``positions`` (committed order), recomputed from the coefficients:
    per chunk of columns the LDE (K1) and a gather (K9) at layout
    positions brev(p), uploaded once for all chunks."""
    batch = rc.coeff_batches[s - rc.log_blowup][1]
    pos = sorted({int(p) for p in positions})
    idx = upload_i64(bit_reverse_indices(s)[pos], batch.device)
    out = []
    for lo in range(0, int(batch.shape[0]), chunk_cols):
        ev = cfft.evaluate(batch[lo:lo + chunk_cols], s)
        out.append(merkle.gather_columns(ev, idx))
        del ev
    return out[0] if len(out) == 1 else torch.cat(out)


def _sharded(mesh, C: int, s: int, memory: MemoryConfig) -> bool:
    """Whether a size group of C columns on the 2^s domain is committed
    over ``mesh``: a column for every rank, rows that split, and no
    streaming."""
    return pcommit.shards_rows(mesh, 1 << s) and C >= mesh.size and \
        not memory.streams(C * (4 << s))


def _as_device(m, device) -> torch.Tensor:
    return (from_u32(m, device) if isinstance(m, np.ndarray)
            else m.to(device=device, dtype=torch.int32))


def _stack(mats: list, n: int, device) -> torch.Tensor:
    """One (C, 2^n) device matrix of a size group's blocks; ``mats`` is
    emptied, so the matrix holds the only references."""
    if all(isinstance(m, np.ndarray) for m in mats):
        dev = from_u32(np.concatenate(mats) if len(mats) > 1 else mats[0],
                       device)
    elif len(mats) == 1:
        dev = _as_device(mats[0], device).contiguous()
    else:
        # one buffer for the group, each block freed as it lands
        C = sum(int(m.shape[0]) for m in mats)
        dev = torch.empty((C, 1 << n), dtype=torch.int32, device=device)
        lo = 0
        for i in range(len(mats)):
            k = int(mats[i].shape[0])
            dev[lo:lo + k] = _as_device(mats[i], device)
            mats[i] = None
            lo += k
    mats.clear()
    return dev


def _commit_group(mats: list, n: int, s: int, device, memory: MemoryConfig,
                  mesh, natural: bool = True, keep_natural: bool = False):
    """Commit one size group on the 2^s domain: its blocks ``mats``
    ((k_i, 2^n) natural-order values, or coefficients without
    ``natural``; the list is emptied) over ``mesh`` (:func:`_sharded`),
    streamed, or resident.  Returns (the natural matrix when
    ``keep_natural``, coefficients, committed evaluations or None when
    streamed, tree).  Without ``keep_natural`` a big group of tensor
    blocks is interpolated in place."""
    host = all(isinstance(m, np.ndarray) for m in mats)
    mat = _stack(mats, n, device)
    nat = mat if keep_natural else None
    C = int(mat.shape[0])
    if _sharded(mesh, C, s, memory):
        return (nat,) + pcommit.commit_group(mesh, mat, n, s, natural)
    if natural and memory.streams(C * (4 << n)):
        mat = _interpolate_big(mat, n, in_place=not (keep_natural or host))
    elif natural:
        mat = cfft.interpolate(mat[:, dev_layout_to_natural(n, mat.device)])
    if memory.streams(C * (4 << s)):
        return nat, mat, None, _stream_commit(mat, s, memory.chunk_cols(s))
    ev = cfft.evaluate(mat, s)[:, dev_bit_reverse(s, mat.device)]
    return nat, mat, ev, merkle.commit_matrix(ev)


def _role(role: str, trace_logs, log_blowup: int, groups: dict,
          natural: dict = None) -> RoleCommitment:
    """groups: n -> (column indices, coefficients, evaluations, tree)."""
    by_s = {n + log_blowup: g for n, g in groups.items()}
    return RoleCommitment(
        role=role, trace_logs=list(trace_logs), log_blowup=log_blowup,
        coeff_batches={n: (g[0], g[1]) for n, g in groups.items()},
        evals={s: g[2] for s, g in by_s.items()},
        cols_by_size={s: g[0] for s, g in by_s.items()},
        trees={s: g[3] for s, g in by_s.items()}, natural=natural)


def commit_blocks(role: str, blocks, block_logs, log_blowup: int, device,
                  keep_natural: bool = True,
                  memory: MemoryConfig = MemoryConfig(),
                  mesh=None) -> RoleCommitment:
    """Commit pre-stacked column blocks: blocks[i] is a (k_i, 2^n_i)
    numpy uint32 array or int32 tensor of consecutive columns.  A list
    of blocks is emptied (the size groups hold the only references);
    without ``keep_natural`` a big size group of tensor blocks is
    interpolated in place, in memory the commitment owns from then on.
    ``mesh``: the groups it can split are committed over it."""
    by_n, idxs_by_n, trace_logs = {}, {}, []
    for b, n in zip(blocks, block_logs):
        k = int(b.shape[0])
        by_n.setdefault(n, []).append(b)
        idxs_by_n.setdefault(n, []).extend(
            range(len(trace_logs), len(trace_logs) + k))
        trace_logs += [n] * k
    b = None
    if isinstance(blocks, list):
        blocks.clear()
    groups, natural = {}, {}
    for n, mats in by_n.items():
        nat, *committed = _commit_group(mats, n, n + log_blowup, device,
                                        memory, mesh,
                                        keep_natural=keep_natural)
        if keep_natural:
            natural[n] = (idxs_by_n[n], nat)
        groups[n] = (idxs_by_n[n], *committed)
        del nat, committed
    return _role(role, trace_logs, log_blowup, groups, natural)


def commit_columns(role: str, columns, trace_logs, log_blowup: int, device,
                   keep_natural: bool = True,
                   memory: MemoryConfig = MemoryConfig(),
                   mesh=None) -> RoleCommitment:
    """columns: natural-order numpy uint32 arrays of sizes
    2^trace_logs[i], committed in this order."""
    return commit_blocks(role, [np.asarray(c, np.uint32)[None, :]
                                for c in columns],
                         list(trace_logs), log_blowup, device, keep_natural,
                         memory, mesh)


def commit_from_coeffs(role: str, coeffs: torch.Tensor, trace_log: int,
                       log_blowup: int,
                       memory: MemoryConfig = MemoryConfig(),
                       mesh=None) -> RoleCommitment:
    """Commit a (C, 2^trace_log) coefficient matrix (one size group)."""
    C = int(coeffs.shape[0])
    _nat, *committed = _commit_group([coeffs], trace_log,
                                     trace_log + log_blowup, coeffs.device,
                                     memory, mesh, natural=False)
    return _role(role, [trace_log] * C, log_blowup,
                 {trace_log: (list(range(C)), *committed)})


def open_positions(queries, s0: int, s: int):
    """Sorted opened positions {p, p^1}, p = q >> (s0 - s)."""
    out = set()
    for q in queries:
        p = int(q) >> (s0 - s)
        out.update((p, p ^ 1))
    return sorted(out)

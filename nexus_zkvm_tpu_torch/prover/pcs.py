"""Polynomial commitment scheme: LDE + Merkle trees per role, resident.

One Merkle tree per (role, eval-domain size); committed order is the
bit-reversed layout.  Columns enter in natural row order, move to the
device once per size group as a (C, 2^n) int32 matrix, are interpolated
(K1), and each size group is evaluated on its blown-up domain (K1),
permuted to committed order and committed (K2).  Everything stays on
the device: coefficients, committed evals and every tree layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import cfft, merkle
from ..ops.circle import (natural_to_layout, dev_bit_reverse,
                          dev_layout_to_natural)
from ..utils.device import from_u32

__all__ = ["RoleCommitment", "commit_columns", "commit_blocks",
           "commit_from_coeffs", "open_positions"]


@dataclass
class RoleCommitment:
    role: str
    trace_logs: list          # per column, commit order within the role
    log_blowup: int
    coeff_batches: dict       # n -> (column index list, (Cn, 2^n) tensor)
    evals: dict               # eval_log -> (C, 2^s) tensor, committed order
    cols_by_size: dict        # eval_log -> [column indices]
    trees: dict               # eval_log -> MerkleTree
    natural: dict = None      # n -> (column index list, (Cn, 2^n) tensor)
    _roots: list = field(default=None, repr=False)

    def sizes_desc(self):
        return sorted(self.trees, reverse=True)

    def roots(self):
        if self._roots is None:
            self._roots = [(s, self.trees[s].root())
                           for s in self.sizes_desc()]
        return self._roots

    def mix_roots(self, channel):
        for _s, root in self.roots():
            channel.mix_u32s(root)

    def _rows(self, batches, col_idxs):
        ns = {self.trace_logs[i] for i in col_idxs}
        assert len(ns) == 1
        n = ns.pop()
        idxs, batch = batches[n]
        rowmap = {ci: r for r, ci in enumerate(idxs)}
        sel = [rowmap[i] for i in col_idxs]
        if sel == list(range(batch.shape[0])):
            return batch, n
        return batch[torch.as_tensor(sel, device=batch.device)], n

    def coeff_rows(self, col_idxs):
        """(len(col_idxs), 2^n) coefficient rows and their n."""
        return self._rows(self.coeff_batches, col_idxs)

    def natural_rows(self, col_idxs):
        return self._rows(self.natural, col_idxs)

    def evals_natural_matrix(self, col_idxs, eval_log: int):
        """(C, 2^eval_log) natural-order evaluations, or None."""
        if not col_idxs:
            return None
        batch, n = self.coeff_rows(col_idxs)
        assert eval_log >= n
        ev = cfft.evaluate(batch, eval_log)
        idx = torch.as_tensor(natural_to_layout(eval_log), device=ev.device)
        return ev[:, idx]


def _commit_groups(role, trace_logs, coeff_batches, log_blowup):
    cols_by_size, evals, trees = {}, {}, {}
    for i, n in enumerate(trace_logs):
        cols_by_size.setdefault(n + log_blowup, []).append(i)
    for s, idxs in sorted(cols_by_size.items(), reverse=True):
        b_idxs, batch = coeff_batches[s - log_blowup]
        assert b_idxs == idxs
        ev = cfft.evaluate(batch, s)[:, dev_bit_reverse(s, batch.device)]
        evals[s] = ev
        trees[s] = merkle.commit_matrix(ev)
    return RoleCommitment(role=role, trace_logs=list(trace_logs),
                          log_blowup=log_blowup, coeff_batches=coeff_batches,
                          evals=evals, cols_by_size=cols_by_size,
                          trees=trees)


def _to_device(mats, device) -> torch.Tensor:
    """Stack host numpy / device blocks of one size into (C, 2^n) int32."""
    if all(isinstance(m, np.ndarray) for m in mats):
        return from_u32(np.concatenate(mats) if len(mats) > 1 else mats[0],
                        device)
    mats = [from_u32(m, device) if isinstance(m, np.ndarray)
            else m.to(device=device, dtype=torch.int32) for m in mats]
    return mats[0].contiguous() if len(mats) == 1 else torch.cat(mats)


def commit_blocks(role: str, blocks, block_logs, log_blowup: int, device,
                  keep_natural: bool = True) -> RoleCommitment:
    """Commit pre-stacked column blocks: blocks[i] is a (k_i, 2^n_i)
    numpy uint32 array or int32 tensor of consecutive columns."""
    by_n, idxs_by_n, trace_logs = {}, {}, []
    for b, n in zip(blocks, block_logs):
        k = int(b.shape[0])
        by_n.setdefault(n, []).append(b)
        idxs_by_n.setdefault(n, []).extend(
            range(len(trace_logs), len(trace_logs) + k))
        trace_logs += [n] * k
    coeff_batches, natural = {}, {}
    for n, mats in by_n.items():
        dev = _to_device(mats, device)
        if keep_natural:
            natural[n] = (idxs_by_n[n], dev)
        coeff_batches[n] = (idxs_by_n[n], cfft.interpolate(
            dev[:, dev_layout_to_natural(n, dev.device)]))
    rc = _commit_groups(role, trace_logs, coeff_batches, log_blowup)
    rc.natural = natural
    return rc


def commit_columns(role: str, columns, trace_logs, log_blowup: int, device,
                   keep_natural: bool = True) -> RoleCommitment:
    """columns: natural-order numpy uint32 arrays of sizes
    2^trace_logs[i], committed in this order."""
    return commit_blocks(role, [np.asarray(c, np.uint32)[None, :]
                                for c in columns],
                         list(trace_logs), log_blowup, device, keep_natural)


def commit_from_coeffs(role: str, coeffs: torch.Tensor, trace_log: int,
                       log_blowup: int) -> RoleCommitment:
    """Commit a (C, 2^trace_log) coefficient matrix (one size group)."""
    C = int(coeffs.shape[0])
    return _commit_groups(role, [trace_log] * C,
                          {trace_log: (list(range(C)), coeffs)}, log_blowup)


def open_positions(queries, s0: int, s: int):
    """Sorted opened positions {p, p^1}, p = q >> (s0 - s)."""
    out = set()
    for q in queries:
        p = int(q) >> (s0 - s)
        out.update((p, p ^ 1))
    return sorted(out)

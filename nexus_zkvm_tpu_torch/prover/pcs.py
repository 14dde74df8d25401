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
the active mesh) nothing streams, and a size group whose rows split
(``parallel.commit.shards_rows``) is committed through
``parallel/commit.py``: each rank keeps the coefficients of its share of
the columns and the committed-order row window of the evaluations, and
its tree over that window (:class:`RoleCommitment` ``shares`` says which
columns and rows).  A smaller group is held whole by every rank.  Where
its 2^n natural rows split too, a rank keeps of the natural values only
its natural-order row window and the halo around it that the
interaction reads (``natural_spans``), and the interaction's groups
arrive as those windows (``row_windows``): step 0 of
``parallel/commit.py`` gives each rank its share of the columns.
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
           "lde_window"]


@dataclass
class RoleCommitment:
    role: str
    trace_logs: list          # per column, commit order within the role
    log_blowup: int
    coeff_batches: dict       # n -> (column index list, (Cn, 2^n) tensor):
                              # the columns this rank holds
    evals: dict               # eval_log -> (C, 2^s) committed order (a
                              # mesh rank: its row window); None for a
                              # streamed size
    cols_by_size: dict        # eval_log -> [column indices]
    trees: dict               # eval_log -> MerkleTree
    natural: dict = None      # n -> (column index list, (Cn, 2^n) tensor,
                              # or a split group's (Cn, W) window block)
    natural_spans: dict = None  # n -> (lo, L, hneg) of a split group: its
                              # block's position q holds natural row
                              # lo - hneg + q (mod 2^n)
    shares: dict = None       # eval_log -> parallel.commit.Share
    mesh: object = None       # the mesh (two or more ranks), else None
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
        """(rows, n): the natural values of ``col_idxs`` (one size n),
        all 2^n rows, or the window block of a split group
        (`natural_span`)."""
        return self._rows(self.natural, col_idxs)

    def natural_span(self, n: int):
        """(lo, L, hneg) of the natural window a rank keeps of size n's
        group, None when it keeps all of it."""
        return (self.natural_spans or {}).get(n)

    def samples(self, ridx: int) -> bool:
        """Whether this rank samples column ``ridx`` at the OODS point:
        the owner of its coefficients in a split group, rank 0 in a
        whole one (so a disjoint sum over the ranks holds each once)."""
        n = self.trace_logs[ridx]
        if self.shares[n + self.log_blowup].size == 1:
            return self.mesh is None or self.mesh.rank == 0
        return ridx in self.coeff_batches[n][0]

    def coeff_source(self, col_idxs, chunk_cols: int):
        """(fetch, ranges) over the coefficient rows ``col_idxs`` (one
        size): ``fetch(lo, hi)`` gives rows col_idxs[lo:hi] on every
        rank, for each (lo, hi) of ``ranges`` (at most ``chunk_cols``
        rows).  A split group's rows are broadcast by their owner, so no
        range crosses two owners' shares; a whole group's are read where
        they lie."""
        n = self.trace_logs[col_idxs[0]]
        s = n + self.log_blowup
        sh, C = self.shares[s], len(col_idxs)
        if sh.size == 1:
            rows = self.coeff_rows(col_idxs)[0]
            return ((lambda lo, hi: rows[lo:hi]),
                    [(lo, min(lo + chunk_cols, C))
                     for lo in range(0, C, chunk_cols)])
        pos = {ci: j for j, ci in enumerate(self.cols_by_size[s])}
        owners = [sh.owner(pos[ci]) for ci in col_idxs]
        ranges, lo = [], 0
        while lo < C:
            hi = lo + 1
            while hi < C and hi - lo < chunk_cols and \
                    owners[hi] == owners[lo]:
                hi += 1
            ranges.append((lo, hi))
            lo = hi
        dev = self.coeff_batches[n][1].device

        def fetch(lo, hi):
            q = owners[lo]
            t = (self.coeff_rows(col_idxs[lo:hi])[0]
                 if q == self.mesh.rank else
                 torch.empty((hi - lo, 1 << n), dtype=torch.int32,
                             device=dev))
            return self.mesh.broadcast(t, q)
        return fetch, ranges

    def windows(self) -> list:
        """[(eval_log, (row lo, hi), (column lo, hi), evaluations' shape,
        coefficients' shape)]: what this rank holds of each size group,
        descending (a streamed group's evaluations: None)."""
        return [(s, self.shares[s].rows, self.shares[s].cols,
                 None if self.evals[s] is None else
                 tuple(self.evals[s].shape),
                 tuple(self.coeff_batches[s - self.log_blowup][1].shape))
                for s in self.sizes_desc()]


def lde_window(fetch, ranges, C: int, ev_log: int, start: int, width: int,
               device) -> torch.Tensor:
    """(C, width) evaluations of C coefficient rows at natural rows start,
    start + 1, .. (mod 2^ev_log) of the 2^ev_log domain: for each (lo,
    hi) of ``ranges`` the whole-domain LDE (K1) of ``fetch(lo, hi)``,
    rows lo..hi, then a gather of the rows (a window past either end of
    the domain wraps).  The output is allocated after the first chunk's
    LDE, so a single chunk never holds its zero-extended input beside
    it."""
    rows = torch.arange(start, start + width, device=device) % (1 << ev_log)
    idx = dev_natural_to_layout(ev_log, device)[rows]
    out = None
    for lo, hi in ranges:
        ev = cfft.evaluate(fetch(lo, hi), ev_log)
        if out is None:
            out = torch.empty((C, width), dtype=torch.int32, device=device)
        torch.index_select(ev, 1, idx, out=out[lo:hi])
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


def _as_device(m, device) -> torch.Tensor:
    return (from_u32(m, device) if isinstance(m, np.ndarray)
            else m.to(device=device, dtype=torch.int32))


def _stack(mats: list, width: int, device) -> torch.Tensor:
    """One (C, width) device matrix of a size group's blocks; ``mats`` is
    emptied, so the matrix holds the only references."""
    if all(isinstance(m, np.ndarray) for m in mats):
        dev = from_u32(np.concatenate(mats) if len(mats) > 1 else mats[0],
                       device)
    elif len(mats) == 1:
        dev = _as_device(mats[0], device).contiguous()
    else:
        # one buffer for the group, each block freed as it lands
        C = sum(int(m.shape[0]) for m in mats)
        dev = torch.empty((C, width), dtype=torch.int32, device=device)
        lo = 0
        for i in range(len(mats)):
            k = int(mats[i].shape[0])
            dev[lo:lo + k] = _as_device(mats[i], device)
            mats[i] = None
            lo += k
    mats.clear()
    return dev


def _natural_window(mesh, mat: torch.Tensor, n: int, halo: tuple):
    """A contiguous copy of this rank's natural window of a (C, 2^n)
    group and ``halo`` = (hneg, hpos) rows around it (the domain wraps),
    and its (lo, L, hneg)."""
    lo, hi = pcommit.window(mesh, 1 << n)
    hneg, hpos = halo
    rows = torch.arange(lo - hneg, hi + hpos, device=mat.device) % (1 << n)
    return torch.index_select(mat, 1, rows), (lo, hi - lo, hneg)


def _commit_group(mats: list, n: int, s: int, device, memory: MemoryConfig,
                  mesh, natural: bool = True, keep_natural: bool = False,
                  halo: tuple = (0, 0), row_windows: bool = False):
    """Commit one size group on the 2^s domain: its blocks ``mats``
    ((k_i, 2^n) natural-order values, or coefficients without
    ``natural``; the list is emptied) in row windows over ``mesh``
    (when its rows split), streamed (never under a mesh), or resident.
    ``row_windows``: where ``mesh`` splits the 2^n natural rows, the
    blocks are this rank's natural window of them (step 0 of
    ``parallel/commit.py``).  Returns (the natural values when
    ``keep_natural``: all of them, or where the 2^n rows split this
    rank's window with ``halo`` = (hneg, hpos) rows around it, then its
    (lo, L, hneg), else None; coefficients; committed evaluations or
    None when streamed; tree; this rank's ``Share``).  Without
    ``keep_natural`` a big group of tensor blocks is interpolated in
    place."""
    split_n = pcommit.shards_rows(mesh, 1 << n)
    if row_windows and split_n:
        C = sum(int(m.shape[0]) for m in mats)
        sh = pcommit.share(mesh, C, 1 << s)
        return (None, None) + pcommit.commit_windows(mesh, mats, n, s) + \
            (sh,)
    host = all(isinstance(m, np.ndarray) for m in mats)
    mat = _stack(mats, 1 << n, device)
    nat, span = (None, None)
    if keep_natural:
        nat, span = (_natural_window(mesh, mat, n, halo) if split_n
                     else (mat, None))
    C = int(mat.shape[0])
    sh = pcommit.share(mesh, C, 1 << s)
    if sh.size > 1:
        return (nat, span) + pcommit.commit_group(mesh, mat, n, s, natural) \
            + (sh,)
    # nothing streams under a mesh, as in the JAX package
    big = (mesh is None or mesh.size == 1) and memory.streams(C * (4 << s))
    if natural and big and memory.streams(C * (4 << n)):
        mat = _interpolate_big(mat, n, in_place=not (keep_natural or host))
    elif natural:
        mat = cfft.interpolate(mat[:, dev_layout_to_natural(n, mat.device)])
    if big:
        return (nat, span, mat, None,
                _stream_commit(mat, s, memory.chunk_cols(s)), sh)
    ev = cfft.evaluate(mat, s)[:, dev_bit_reverse(s, mat.device)]
    return nat, span, mat, ev, merkle.commit_matrix(ev), sh


def _role(role: str, trace_logs, log_blowup: int, groups: dict,
          natural: dict = None, mesh=None,
          natural_spans: dict = None) -> RoleCommitment:
    """groups: n -> (column indices, coefficients, evaluations, tree,
    Share)."""
    by_s = {n + log_blowup: g for n, g in groups.items()}
    return RoleCommitment(
        role=role, trace_logs=list(trace_logs), log_blowup=log_blowup,
        coeff_batches={n: (g[0][slice(*g[4].cols)], g[1])
                       for n, g in groups.items()},
        evals={s: g[2] for s, g in by_s.items()},
        cols_by_size={s: g[0] for s, g in by_s.items()},
        trees={s: g[3] for s, g in by_s.items()}, natural=natural,
        natural_spans=natural_spans,
        shares={s: g[4] for s, g in by_s.items()},
        mesh=mesh if mesh is not None and mesh.size > 1 else None)


def commit_blocks(role: str, blocks, block_logs, log_blowup: int, device,
                  keep_natural: bool = True,
                  memory: MemoryConfig | None = None,
                  mesh=None, halo: dict = None,
                  row_windows: bool = False) -> RoleCommitment:
    """Commit pre-stacked column blocks: blocks[i] is a (k_i, 2^n_i)
    numpy uint32 array or int32 tensor of consecutive columns.  A list
    of blocks is emptied (the size groups hold the only references);
    without ``keep_natural`` a big size group of tensor blocks is
    interpolated in place, in memory the commitment owns from then on.
    ``mesh``: the groups it can split are committed over it; with
    ``keep_natural``, of a group whose 2^n natural rows it splits a rank
    keeps its window and ``halo[n]`` = (hneg, hpos) rows around it
    (default none), the whole matrix freed once committed;
    ``row_windows``: the blocks of such a size are (k_i, 2^n/D) windows
    (`_commit_group`).  ``memory`` None: `MemoryConfig.for_device`."""
    if memory is None:
        memory = MemoryConfig.for_device(device, mesh)
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
    groups, natural, spans = {}, {}, {}
    for n, mats in by_n.items():
        nat, span, *committed = _commit_group(
            mats, n, n + log_blowup, device, memory, mesh,
            keep_natural=keep_natural, halo=(halo or {}).get(n, (0, 0)),
            row_windows=row_windows)
        if keep_natural:
            natural[n] = (idxs_by_n[n], nat)
        if span is not None:
            spans[n] = span
        groups[n] = (idxs_by_n[n], *committed)
        del nat, committed
    return _role(role, trace_logs, log_blowup, groups, natural, mesh, spans)


def commit_columns(role: str, columns, trace_logs, log_blowup: int, device,
                   keep_natural: bool = True,
                   memory: MemoryConfig | None = None,
                   mesh=None, halo: dict = None) -> RoleCommitment:
    """columns: natural-order numpy uint32 arrays of sizes
    2^trace_logs[i], committed in this order."""
    return commit_blocks(role, [np.asarray(c, np.uint32)[None, :]
                                for c in columns],
                         list(trace_logs), log_blowup, device, keep_natural,
                         memory, mesh, halo)


def commit_from_coeffs(role: str, coeffs: torch.Tensor, trace_log: int,
                       log_blowup: int,
                       memory: MemoryConfig | None = None,
                       mesh=None) -> RoleCommitment:
    """Commit a (C, 2^trace_log) coefficient matrix (one size group);
    ``memory`` None: `MemoryConfig.for_device`."""
    if memory is None:
        memory = MemoryConfig.for_device(coeffs.device, mesh)
    C = int(coeffs.shape[0])
    _nat, _span, *committed = _commit_group(
        [coeffs], trace_log, trace_log + log_blowup, coeffs.device, memory,
        mesh, natural=False)
    return _role(role, [trace_log] * C, log_blowup,
                 {trace_log: (list(range(C)), *committed)}, mesh=mesh)


def open_positions(queries, s0: int, s: int):
    """Sorted opened positions {p, p^1}, p = q >> (s0 - s)."""
    out = set()
    for q in queries:
        p = int(q) >> (s0 - s)
        out.update((p, p ^ 1))
    return sorted(out)

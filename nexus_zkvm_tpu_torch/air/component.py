"""Components and evaluation contexts — the single-source AIR runner.

A ``Component`` declares its main-trace width, optional preprocessed
columns and one ``evaluate(ctx)`` method, which runs under four
interchangeable contexts:

* ``InfoContext``       — shape collection on 4-row dummy data (numpy).
* ``GenContext``        — LogUp interaction generation over the trace
  domain, natural order (torch; offsets are rolls).
* ``DomainEvalContext`` — composition evaluation over the 4x domain
  (torch; offset o is a roll by 4·o).
* ``PointEvalContext``  — the verifier's out-of-domain check (numpy).

Components written against the JAX package's ``Component``/``Felt`` API
run here unchanged: they touch only ``ctx`` methods and ``Felt``
operators.

LogUp layout: with fraction batches F_0..F_{B-1} per row (pairs
n1/d1 + n2/d2 -> (n1·d2 + n2·d1)/(d1·d2)), the interaction trace holds
S_b = F_0 + .. + F_b for b < B-1 and the running column S[i] of the
row totals; claimed_sum = S[last].  Constraints (deg <= 3):
   b = 0:        S_0·D_0 = N_0
   0 < b < B-1:  (S_b - S_{b-1})·D_b = N_b
   last:         (S - S[-1 row] - S_{B-2} + is_first·claimed)·D = N
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import field as F
from .expr import Felt, TorchBackend, NP
from .lookups import LookupElements

__all__ = [
    "Component", "ComponentInfo", "component_info", "InfoContext",
    "GenContext", "DomainEvalContext", "PointEvalContext",
    "generate_interaction", "run_constraints", "run_constraints_domain",
    "preprocessed_is_first", "MAX_CONSTRAINT_DEG",
]

# constraints / v_n must fit the 4x eval domain
MAX_CONSTRAINT_DEG = 4


class Component:
    """Base class. Subclasses set ``name``, ``n_main``, ``evaluate``."""

    name = "component"
    n_main = 0

    def preprocessed(self, log_size: int):
        """Deterministic preprocessed columns: list[(name, np uint32)]."""
        return []

    def params(self) -> dict:
        """Scalar parameters read through ``ctx.param(name)``."""
        return {}

    def evaluate(self, ctx):
        raise NotImplementedError


def preprocessed_is_first(log_size: int) -> np.ndarray:
    col = np.zeros(1 << log_size, np.uint32)
    col[0] = 1
    return col


class _BaseCtx:
    accumulates = False

    def __init__(self, be, relations=None, claimed=None, params=None):
        self.be = be
        self.relations = relations or {}
        self.entries = []          # [(numerator Felt, denominator Felt)]
        self.n_constraints = 0
        self.acc = None
        self.alpha = None
        self._claimed = claimed
        self._params = params or {}

    def param(self, name: str) -> Felt:
        v = self._params[name]
        if isinstance(v, (int, np.integer)):
            return Felt.const(int(v), self.be)
        return Felt(v, "m31", self.be, deg=0)

    def add_fraction(self, mult, rel: str, values):
        den = self.relations[rel].combine(values, self.be)
        num = mult if isinstance(mult, Felt) else Felt.const(int(mult),
                                                             self.be)
        self.entries.append((num, den))

    @property
    def claimed(self) -> Felt:
        return Felt.qconst(self._claimed, self.be)

    def constraint(self, f: Felt):
        assert f.deg <= MAX_CONSTRAINT_DEG, \
            f"constraint degree {f.deg} > {MAX_CONSTRAINT_DEG}"
        self.n_constraints += 1
        if self.accumulates:
            self._accumulate(f)

    def constraint_vec(self, arr, count: int):
        """``count`` consecutive QM31 constraints, arr[b] each."""
        self.n_constraints += count
        if self.accumulates:
            self._accumulate_vec(arr, count)

    def _accumulate(self, f: Felt):
        f = f.as_qm31()
        self.acc = f if self.acc is None else self.acc * self.alpha + f

    def _accumulate_vec(self, arr, count: int):
        for b in range(count):
            self._accumulate(Felt(arr[b], "qm31", self.be))


def _pair_entries(entries, be):
    entries = list(entries)
    if len(entries) % 2:
        entries.append((Felt.const(0, be),
                        Felt.qconst(np.array([1, 0, 0, 0]), be)))
    return [(entries[i], entries[i + 1]) for i in range(0, len(entries), 2)]


def _pair_fraction(e1, e2, shape=None):
    """(N, D) of n1/d1 + n2/d2 as QM31 payloads."""
    (n1, d1), (n2, d2) = e1, e2
    n1, d1, n2, d2 = (x.as_qm31().v for x in (n1, d1, n2, d2))
    numer = F.qm31_add(F.qm31_mul(n1, d2), F.qm31_mul(n2, d1))
    dd = F.qm31_mul(d1, d2)
    if shape is not None:
        numer, dd = numer.expand(shape), dd.expand(shape)
    return numer, dd


def _finalize_logup(ctx):
    """Emit the LogUp column constraints for the collected entries."""
    if not ctx.entries:
        return
    if ctx.be.name == "torch":
        return _finalize_logup_torch(ctx)
    batches = [ctx.entries[i:i + 2] for i in range(0, len(ctx.entries), 2)]
    nb = len(batches)
    claimed = ctx.claimed
    for b, batch in enumerate(batches):
        if len(batch) == 2:
            (n1, d1), (n2, d2) = batch
            numer = n1 * d2 + n2 * d1
            dd = d1 * d2
        else:
            (numer, dd), = batch
        s_b = ctx.inter(b, 0)
        if b == nb - 1:
            lhs = s_b - ctx.inter(b, -1) + ctx.is_first * claimed
            if nb > 1:
                lhs = lhs - ctx.inter(b - 1, 0)
        elif b == 0:
            lhs = s_b
        else:
            lhs = s_b - ctx.inter(b - 1, 0)
        ctx.constraint(lhs * dd - numer)


def _finalize_logup_torch(ctx):
    """Same constraints as the loop above, one batch at a time (keeps
    the device working set to one (M, 4) batch)."""
    pairs = _pair_entries(ctx.entries, ctx.be)
    nb = len(pairs)
    cons, prev = [], None
    for b, (e1, e2) in enumerate(pairs):
        inter_b = ctx.inter(b, 0).v
        numer, dd = _pair_fraction(e1, e2, inter_b.shape)
        lhs = inter_b if prev is None else F.qm31_sub(inter_b, prev)
        if b == nb - 1:
            lhs = F.qm31_add(lhs, F.qm31_sub(
                (ctx.is_first * ctx.claimed).as_qm31().v,
                ctx.inter(b, -1).v))
        cons.append(F.qm31_sub(F.qm31_mul(lhs, dd), numer))
        prev = inter_b
    ctx.constraint_vec(cons, nb)


class InfoContext(_BaseCtx):
    """Shape collection on 4-row dummy data (numpy)."""
    ROWS = 4

    def __init__(self, params=None):
        super().__init__(NP, claimed=np.zeros(4, np.uint64), params=params)
        self.masks_main, self.masks_pre, self.masks_inter = {}, {}, {}
        self.relation_widths = {}

    def add_fraction(self, mult, rel, values):
        self.relation_widths[rel] = max(self.relation_widths.get(rel, 0),
                                        len(values))
        if rel not in self.relations:
            self.relations[rel] = LookupElements.dummy(rel, 32)
        super().add_fraction(mult, rel, values)

    def main(self, i: int, off: int = 0) -> Felt:
        self.masks_main.setdefault(i, set()).add(off)
        return Felt(np.zeros(self.ROWS, np.uint64), "m31", NP)

    def pre(self, j: int, off: int = 0) -> Felt:
        self.masks_pre.setdefault(j, set()).add(off)
        return Felt(np.zeros(self.ROWS, np.uint64), "m31", NP)

    def inter(self, b: int, off: int = 0) -> Felt:
        self.masks_inter.setdefault(b, set()).add(off)
        return Felt(np.zeros((self.ROWS, 4), np.uint64), "qm31", NP)

    @property
    def is_first(self) -> Felt:
        col = np.zeros(self.ROWS, np.uint64)
        col[0] = 1
        return Felt(col, "m31", NP)


@dataclass
class ComponentInfo:
    n_main: int
    n_pre: int
    n_logup_cols: int                  # B (QM31 columns)
    n_constraints: int
    masks_main: dict                   # i -> sorted tuple of offsets
    masks_pre: dict
    masks_inter: dict                  # b -> sorted tuple of offsets
    relation_widths: dict


def component_info(component) -> ComponentInfo:
    """Column counts, masks and relation widths of a component."""
    ctx = InfoContext(params=component.params())
    component.evaluate(ctx)
    nb = (len(ctx.entries) + 1) // 2
    _finalize_logup(ctx)
    n_pre = len(component.preprocessed(4))
    return ComponentInfo(
        n_main=component.n_main, n_pre=n_pre, n_logup_cols=nb,
        n_constraints=ctx.n_constraints,
        masks_main={i: tuple(sorted(ctx.masks_main.get(i, set()) | {0}))
                    for i in range(component.n_main)},
        masks_pre={j: tuple(sorted(ctx.masks_pre.get(j, set()) | {0}))
                   for j in range(n_pre)},
        masks_inter={b: tuple(sorted(ctx.masks_inter.get(b, set()) | {0}))
                     for b in range(nb)},
        relation_widths=dict(ctx.relation_widths))


class GenContext(_BaseCtx):
    """Interaction generation over the trace domain (natural order).
    Columns live in one (C, M) matrix per role."""

    def __init__(self, main_matrix, pre_matrix, relations, log_size: int,
                 device, params=None):
        super().__init__(TorchBackend(device), relations=relations,
                         params=params)
        self.log_size = log_size
        self._main = main_matrix
        self._pre = pre_matrix

    def _row(self, mat, i, off):
        c = mat[i]
        return Felt(torch.roll(c, -off, 0) if off else c, "m31", self.be)

    def main(self, i: int, off: int = 0) -> Felt:
        return self._row(self._main, i, off)

    def pre(self, j: int, off: int = 0) -> Felt:
        return self._row(self._pre, j, off)

    def main_block(self, lo: int, hi: int, off: int = 0) -> Felt:
        c = self._main[lo:hi]
        return Felt(torch.roll(c, -off, -1) if off else c, "m31", self.be)

    @property
    def is_first(self) -> Felt:
        col = torch.zeros(1 << self.log_size, dtype=torch.int64,
                          device=self.be.device)
        col[0] = 1
        return Felt(col, "m31", self.be)

    def inter(self, b, off=0):
        raise RuntimeError("interaction columns not available during gen")


def generate_interaction(component, main_matrix, pre_matrix, relations,
                         log_size: int, device):
    """Run evaluate() to collect fractions and build the LogUp columns.

    Returns ((B, M, 4) int32 natural-order columns, (4,) claimed sum
    tensor), or (None, None) for a component without lookups."""
    ctx = GenContext(main_matrix, pre_matrix, relations, log_size, device,
                     params=component.params())
    component.evaluate(ctx)
    if not ctx.entries:
        return None, None
    full = (1 << log_size, 4)
    cols, running = [], None
    for e1, e2 in _pair_entries(ctx.entries, ctx.be):
        numer, dd = _pair_fraction(e1, e2, full)
        frac = F.qm31_mul(numer, F.qm31_inv(dd))
        if running is not None:
            cols.append(running.to(torch.int32))
            frac = F.qm31_add(running, frac)
        running = frac
    # the row totals' prefix sum is the last column: canonical terms over
    # at most 2^31 rows keep the int64 sum exact
    cols.append(torch.remainder(torch.cumsum(running, dim=0), F.P)
                .to(torch.int32))
    out = torch.stack(cols)
    return out, out[-1, -1]


class DomainEvalContext(_BaseCtx):
    """Composition evaluation on the 4x domain (natural order).

    Constraints are collected and combined at the end as
    sum_j alpha^(K-1-j)·c_j — the verifier's Horner order — into one
    int64 accumulator, one constraint at a time."""
    accumulates = True
    EXTRA = 4   # eval-domain rows per trace row

    def __init__(self, main_evals, pre_evals, inter_evals, is_first_evals,
                 relations, claimed, alpha, device, params=None):
        super().__init__(TorchBackend(device), relations=relations,
                         claimed=claimed, params=params)
        self._main = main_evals      # (C, M)
        self._pre = pre_evals        # (P, M)
        self._inter = inter_evals    # (B, M, 4)
        self._is_first = is_first_evals
        self._alpha = np.asarray(alpha, np.uint64)
        self._collected = []         # Felt per constraint

    def _accumulate(self, f: Felt):
        self._collected.append(f)

    def _accumulate_vec(self, arr, count: int):
        for b in range(count):
            self._collected.append(Felt(arr[b], "qm31", self.be))

    def finalize_acc(self):
        if not self._collected:
            self.acc = None
            return None
        K = len(self._collected)
        pows = np.empty((K, 4), np.uint64)
        pows[0] = F.np_qm31(np.uint64(1))
        for e in range(1, K):
            pows[e] = F.np_qm31_mul(pows[e - 1], self._alpha)
        w = self.be.qconst(pows)
        total = None
        for j, f in enumerate(self._collected):
            wj = w[K - 1 - j]
            if f.kind == "m31":
                term = F.m31_mul(wj, F._i64(f.v)[..., None])
            else:
                term = F.qm31_mul(wj, f.v)
            total = term if total is None else total + term
        self._collected = []
        self.acc = Felt(torch.remainder(total, F.P), "qm31", self.be)
        return self.acc.v

    def _roll(self, c, off):
        return torch.roll(c, -off * self.EXTRA, 0) if off else c

    def main(self, i, off=0):
        return Felt(self._roll(self._main[i], off), "m31", self.be)

    def main_block(self, lo: int, hi: int, off: int = 0) -> Felt:
        c = self._main[lo:hi]
        return Felt(torch.roll(c, -off * self.EXTRA, -1) if off else c,
                    "m31", self.be)

    def pre(self, j, off=0):
        return Felt(self._roll(self._pre[j], off), "m31", self.be)

    def inter(self, b, off=0):
        return Felt(self._roll(self._inter[b], off), "qm31", self.be)

    @property
    def is_first(self):
        return Felt(self._is_first, "m31", self.be)


class PointEvalContext(_BaseCtx):
    """Verifier-side constraint evaluation at the OODS point (numpy)."""
    accumulates = True

    def __init__(self, mask_values, relations, claimed, alpha, params=None):
        """mask_values: {('main'|'pre'|'inter'|'is_first', idx, off) -> (4,)}."""
        super().__init__(NP, relations=relations, claimed=claimed,
                         params=params)
        self._vals = mask_values
        self.alpha = Felt.qconst(alpha, NP)

    def _get(self, role, i, off):
        return Felt(np.asarray(self._vals[(role, i, off)], np.uint64),
                    "qm31", NP)

    def main(self, i, off=0):
        return self._get("main", i, off)

    def pre(self, j, off=0):
        return self._get("pre", j, off)

    def inter(self, b, off=0):
        return self._get("inter", b, off)

    @property
    def is_first(self):
        return self._get("is_first", 0, 0)


def run_constraints(component, ctx):
    """Run evaluate + LogUp finalize; returns (acc Felt | None, count)."""
    component.evaluate(ctx)
    _finalize_logup(ctx)
    if hasattr(ctx, "finalize_acc"):
        ctx.finalize_acc()
    return ctx.acc, ctx.n_constraints


def run_constraints_domain(component, main_evals, pre_evals, inter_evals,
                           isf_evals, relations, claimed, alpha, device):
    """Composition accumulator over the 4x domain: ((M, 4) int64 | None,
    n_constraints)."""
    ctx = DomainEvalContext(main_evals, pre_evals, inter_evals, isf_evals,
                            relations, claimed, alpha, device,
                            params=component.params())
    acc, k = run_constraints(component, ctx)
    return (None if acc is None else acc.v), k

"""Constraint-satisfaction assertion harness (no FRI, no commitments).

Counterpart of the reference's `assert_chip` / stwo
`assert_constraints_on_polys`
(`nexus-zkvm/prover/src/test_utils.rs:18-70`): every constraint of a
component set is evaluated directly on the trace domain (offsets are
row rolls) with seeded dummy lookup randomness, and the harness checks
that

* each constraint is identically zero on the trace rows, and
* the LogUp claimed sums cancel across components.

The LogUp interaction columns and claimed sums come from the prover's
own `air.tape.generate_interaction` (kernels K7 and K6 on a CUDA
device, their plain versions on the CPU); the constraints, the LogUp
ones of `finalize_logup` included, are then evaluated one by one on the
host with the numpy ``Felt`` backend, so a violation names the
constraint's index in ``evaluate()`` order and its first bad rows.

`relation_balance_report` is a host multiset count of every relation's
tuples, independent of any randomness.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..ops import field as F
from ..utils.device import from_u32, resolve_device, to_u32
from .component import (BaseContext, component_info, finalize_logup,
                        preprocessed_is_first)
from .expr import Felt, NP
from .lookups import LookupElements
from .tape import generate_interaction

__all__ = ["assert_constraints", "ConstraintViolation",
           "relation_balance_report"]


class ConstraintViolation(AssertionError):
    pass


def _matrix(cols) -> np.ndarray:
    """(C, M) uint32 of a trace: an int32 tensor or a list of columns."""
    if isinstance(cols, torch.Tensor):
        return to_u32(cols)
    if not len(cols):
        return np.zeros((0, 0), np.uint32)
    return np.stack([np.asarray(c, np.uint32) for c in cols])


def _roll(arr, off: int, axis: int = -1):
    return np.roll(arr, -off, axis=axis) if off else arr


class _AssertCtx(BaseContext):
    """Rows of the trace domain as numpy Felts; each constraint is
    checked where it is emitted.  Like the reference harness, no degree
    bound is enforced here (the prover's contexts do that)."""

    def __init__(self, main, pre, inter, relations, claimed, log_size,
                 params=None):
        super().__init__(NP, relations=relations, claimed=claimed,
                         params=params)
        self._main = main.astype(np.uint64)          # (C, M)
        self._pre = pre.astype(np.uint64)            # (P, M)
        self._inter = inter                          # (B, M, 4) uint64
        self.log_size = log_size
        self.violations = []                         # (index, first rows)

    def main(self, i: int, off: int = 0) -> Felt:
        return Felt(_roll(self._main[i], off), "m31", NP)

    def main_block(self, lo: int, hi: int, off: int = 0) -> Felt:
        return Felt(_roll(self._main[lo:hi], off), "m31", NP)

    def pre(self, j: int, off: int = 0) -> Felt:
        return Felt(_roll(self._pre[j], off), "m31", NP)

    def inter(self, b: int, off: int = 0) -> Felt:
        return Felt(_roll(self._inter[b], off, axis=0), "qm31", NP)

    @property
    def is_first(self) -> Felt:
        return Felt(preprocessed_is_first(self.log_size).astype(np.uint64),
                    "m31", NP)

    def _check(self, v) -> None:
        v = np.asarray(v, np.uint64) % np.uint64(F.P)
        bad = np.nonzero(v.reshape(v.shape[0], -1).any(axis=1))[0]
        if len(bad):
            self.violations.append((self.n_constraints, bad[:8].tolist()))
        self.n_constraints += 1

    def constraint(self, f: Felt):
        self._check(f.as_qm31().v)

    def constraint_vec(self, arr, count: int):
        arr = np.asarray(arr, np.uint64)              # (count, M, 4)
        for b in range(count):
            self._check(arr[b])


def _dummy_relations(infos):
    widths = {}
    for info in infos:
        for name, w in info.relation_widths.items():
            widths[name] = max(widths.get(name, 0), w)
    rng = np.random.default_rng(12345)

    def felt():
        return rng.integers(1, F.P, 4).astype(np.uint64)

    out = {}
    for name in sorted(widths):
        pows = [F.np_qm31(np.uint64(1))]
        alpha = felt()
        for _ in range(widths[name] - 1):
            pows.append(F.np_qm31_mul(pows[-1], alpha))
        out[name] = LookupElements(name=name, width=widths[name],
                                   z=felt(),
                                   alpha_pows=np.stack(pows, axis=0))
    return out


def assert_constraints(components, log_sizes, traces,
                       device="cuda") -> None:
    """Raises ConstraintViolation naming every violated constraint's
    index and its first rows, or the LogUp claimed sums' imbalance.
    ``traces``: per component a list of uint32 columns or a (C, M) int32
    tensor; the interaction columns are made on ``device``."""
    dev = resolve_device(device)
    infos = [component_info(c) for c in components]
    relations = _dummy_relations(infos)

    total = np.zeros(4, np.uint64)
    failures = []
    for ci, comp in enumerate(components):
        n = log_sizes[ci]
        main = _matrix(traces[ci])
        pre = _matrix([arr for _, arr in comp.preprocessed(n)])
        inter, claimed = generate_interaction(
            comp, from_u32(main, dev) if len(main) else None,
            from_u32(pre, dev) if len(pre) else None, relations, n, dev)
        if inter is None:
            inter = np.zeros((0, 1 << n, 4), np.uint64)
            claimed = np.zeros(4, np.uint64)
        else:
            inter = to_u32(inter).astype(np.uint64)
            claimed = to_u32(claimed).astype(np.uint64)
        total = F.np_qm31_add(total, claimed)
        ctx = _AssertCtx(main, pre, inter, relations, claimed, n,
                         params=comp.params())
        comp.evaluate(ctx)
        finalize_logup(ctx)
        if ctx.violations:
            failures.append((comp.name, ctx.violations))
    if failures:
        msg = "\n".join(
            f"component {name}: constraints {[k for k, _ in viols]} "
            f"violated (first rows: {viols[0][1]})"
            for name, viols in failures)
        raise ConstraintViolation(msg)
    if total.any():
        raise ConstraintViolation(
            f"LogUp claimed sums do not cancel: {total}")


class _TupleCtx:
    """Records every add_fraction as (relation, mult rows, value rows)
    for the host-side multiset balance report (no field randomness)."""
    be = NP

    def __init__(self, main_cols, pre_cols, log_size, params, claimed):
        self._main = [np.asarray(c, np.int64) for c in main_cols]
        self._pre = [np.asarray(c, np.int64) for c in pre_cols]
        self.log_size = log_size
        self._params = params or {}
        self._claimed = claimed
        self.records = []          # (rel, mult (M,), [vals (M,)])
        self.n_constraints = 0
        self.entries = []

    def _col(self, arr, off):
        return np.roll(arr, -off) if off else arr

    def _felt(self, arr):
        return Felt(np.asarray(arr, np.uint64), "m31", NP)

    def main(self, i, off=0):
        return self._felt(self._col(self._main[i], off))

    def pre(self, j, off=0):
        return self._felt(self._col(self._pre[j], off))

    def main_block(self, lo, hi, off=0):
        block = np.stack([self._col(c, off)
                          for c in self._main[lo:hi]])
        return Felt(np.asarray(block, np.uint64), "m31", NP)

    def inter(self, b, off=0):
        raise RuntimeError("no interaction columns in tuple context")

    @property
    def is_first(self):
        return self._felt(preprocessed_is_first(self.log_size))

    @property
    def claimed(self):
        return Felt.qconst(self._claimed, NP)

    def param(self, name):
        return Felt.const(int(self._params[name]), NP)

    def constraint(self, f):
        self.n_constraints += 1

    def constraint_vec(self, arr, count):
        self.n_constraints += count

    def add_fraction(self, mult, rel, values):
        M = 1 << self.log_size

        def rows(v):
            if isinstance(v, Felt):
                a = np.asarray(v.v, np.int64)
            else:
                a = np.asarray(int(v) % F.P, np.int64)
            return np.broadcast_to(a, (M,)) if a.ndim == 0 else a

        self.records.append((rel, rows(mult), [rows(v) for v in values]))


def relation_balance_report(components, log_sizes, traces, max_show=8):
    """Host multiset check of every LogUp relation: emitted minus
    consumed tuple counts must be zero.  Returns {relation: [(tuple,
    residual), ...]} for the unbalanced tuples: the exact witness of a
    claimed-sums imbalance, independent of randomness."""
    totals = defaultdict(lambda: defaultdict(int))
    half = F.P // 2
    for ci, comp in enumerate(components):
        n = log_sizes[ci]
        pre = [np.asarray(arr, np.int64)
               for _, arr in comp.preprocessed(n)]
        ctx = _TupleCtx(_matrix(traces[ci]), pre, n, comp.params(),
                        np.zeros(4, np.uint64))
        comp.evaluate(ctx)
        for rel, mult, vals in ctx.records:
            signed = np.where(mult > half, mult - F.P, mult)
            nz = np.nonzero(signed)[0]
            if not len(nz):
                continue
            stacked = np.stack([v[nz] for v in vals], axis=1)
            for row, m in zip(stacked, signed[nz]):
                totals[rel][tuple(int(x) for x in row)] += int(m)
    report = {}
    for rel, counts in totals.items():
        bad = [(k, v) for k, v in counts.items() if v != 0]
        if bad:
            report[rel] = sorted(bad)[:max_show]
    return report

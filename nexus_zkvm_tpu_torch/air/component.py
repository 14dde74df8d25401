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

from .. import kernels
from ..ops import field as F
from ..utils.profile import scope
from .expr import Felt, TorchBackend, NP
from .lookups import LookupElements

__all__ = [
    "Component", "ComponentInfo", "component_info", "InfoContext",
    "GenContext", "DomainEvalContext", "PointEvalContext",
    "generate_interaction", "logup_operands", "logup_columns",
    "logup_columns_plain",
    "run_constraints", "run_constraints_domain", "preprocessed_is_first",
    "MAX_CONSTRAINT_DEG",
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
    """Run evaluate() to collect fractions and build the LogUp columns
    (kernel K6 on a CUDA device).

    Returns ((B, M, 4) int32 natural-order columns, (4,) claimed sum
    tensor), or (None, None) for a component without lookups."""
    M = 1 << log_size
    with scope("i:eval"):
        ctx = GenContext(main_matrix, pre_matrix, relations, log_size,
                         device, params=component.params())
        component.evaluate(ctx)
        if not ctx.entries:
            return None, None
        src, meta = logup_operands(_pair_entries(ctx.entries, ctx.be), M)
    with scope("i:logup"):
        out = logup_columns(src, meta, M)
    return out, out[-1, -1]


# operand modes of the LogUp kernel's packed input
_M31_CONST, _M31_COL, _QM31_CONST, _QM31_COL = range(4)


def logup_operands(pairs, M: int):
    """Pack the (n1, d1, n2, d2) operands of every pair into one int32
    buffer (on the operands' device) and a host (4, B, 2) int64 table of
    (word offset, mode): constants and M31 columns are packed as they
    are, not widened to (M, 4)."""
    pieces, meta, off = [], [], 0
    for k in range(4):
        for pair in pairs:
            f = pair[k // 2][k % 2]
            v = f.v
            if f.kind == "m31" and v.dim() == 0:
                v, mode = v.reshape(1), _M31_CONST
            elif f.kind == "m31" and tuple(v.shape) == (M,):
                mode = _M31_COL
            elif f.kind == "qm31" and tuple(v.shape) == (4,):
                mode = _QM31_CONST
            else:
                v, mode = f.as_qm31().v.expand(M, 4).reshape(-1), _QM31_COL
            pieces.append(v.reshape(-1).to(torch.int32))
            meta.append((off, mode))
            off += pieces[-1].numel()
    meta = torch.tensor(meta, dtype=torch.int64).reshape(4, len(pairs), 2)
    return torch.cat(pieces), meta


def _operand(src, off: int, mode: int, M: int):
    if mode == _M31_CONST:
        return F.qm31_from_m31(src[off:off + 1].to(torch.int64))
    if mode == _M31_COL:
        return F.qm31_from_m31(src[off:off + M].to(torch.int64))
    if mode == _QM31_CONST:
        return src[off:off + 4].to(torch.int64)[None, :]
    return src[off:off + 4 * M].to(torch.int64).reshape(M, 4)


def logup_columns_plain(src, meta, M: int) -> torch.Tensor:
    """(B, M, 4) int32: S_b = f_0 + .. + f_b for b < B - 1, then the
    prefix sum over rows of the row totals; f_b = (n1·d2 + n2·d1) /
    (d1·d2) for pair b of the packed operands."""
    table = meta.tolist()
    B = len(table[0])
    cols, running = [], None
    for b in range(B):
        n1, d1, n2, d2 = (_operand(src, *table[k][b], M) for k in range(4))
        numer = F.qm31_add(F.qm31_mul(n1, d2), F.qm31_mul(n2, d1))
        frac = F.qm31_mul(numer, F.qm31_inv(F.qm31_mul(d1, d2)))
        frac = frac.expand(M, 4)
        if running is not None:
            cols.append(running.to(torch.int32))
            frac = F.qm31_add(running, frac)
        running = frac
    # the row totals' prefix sum is the last column: canonical terms over
    # at most 2^31 rows keep the int64 sum exact
    cols.append(torch.remainder(torch.cumsum(running, dim=0), F.P)
                .to(torch.int32))
    return torch.stack(cols)


def _check_meta(meta, n_words: int, M: int) -> None:
    if meta.device.type != "cpu" or meta.dtype != torch.int64 or \
            meta.dim() != 3 or meta.shape[0] != 4 or meta.shape[2] != 2 or \
            meta.shape[1] == 0:
        raise ValueError("meta must be a host (4, B, 2) int64 tensor, B > 0")
    off, mode = meta[..., 0], meta[..., 1]
    if not bool(((mode >= 0) & (mode <= 3) & (off >= 0)).all()):
        raise ValueError("meta holds a bad mode or offset")
    words = torch.tensor([1, M, 4, 4 * M])[mode]
    if int((off + words).max()) > n_words:
        raise ValueError("meta points outside the operand buffer")


def logup_columns(src, meta, M: int) -> torch.Tensor:
    """The LogUp columns of the packed pairs (see `logup_operands`; meta
    stays on the host): launches ``csrc/logup.cu`` on a CUDA ``src``,
    runs `logup_columns_plain` on a CPU one."""
    _check_meta(meta, src.numel(), M)
    if src.is_cuda:
        kernels.check_cuda_tensor(src, "operands", ndim=1)
        B = int(meta.shape[1])
        meta_dev = meta.contiguous().to(src.device)
        out = torch.empty((B, M, 4), dtype=torch.int32, device=src.device)
        scratch = torch.empty(((M + 255) // 256, 4), dtype=torch.int32,
                              device=src.device)
        kernels.launch("logup_columns", src.data_ptr(), meta_dev.data_ptr(),
                       B, M, out.data_ptr(), scratch.data_ptr())
        return out
    if src.device.type == "cpu":
        return logup_columns_plain(src, meta, M)
    raise ValueError(f"unsupported device {src.device}")


class DomainEvalContext(_BaseCtx):
    """Composition evaluation on the 4x domain (natural order).

    Constraints combine as sum_j alpha^(K-1-j)·c_j — the verifier's
    Horner order — in chunks of CHUNK: each full chunk is summed with
    its own alpha powers and folded into the accumulator as
    acc·alpha^k + chunk, so at most CHUNK constraint tensors are held
    at once."""
    accumulates = True
    EXTRA = 4   # eval-domain rows per trace row
    CHUNK = 64

    def __init__(self, main_evals, pre_evals, inter_evals, is_first_evals,
                 relations, claimed, alpha, device, params=None):
        super().__init__(TorchBackend(device), relations=relations,
                         claimed=claimed, params=params)
        self._main = main_evals      # (C, M)
        self._pre = pre_evals        # (P, M)
        self._inter = inter_evals    # (B, M, 4)
        self._is_first = is_first_evals
        self._alpha = np.asarray(alpha, np.uint64)
        self._collected = []         # Felt per constraint of this chunk
        self._total = None           # (M, 4) canonical, earlier chunks
        pows = np.empty((self.CHUNK + 1, 4), np.uint64)
        pows[0] = F.np_qm31(np.uint64(1))
        for e in range(1, self.CHUNK + 1):
            pows[e] = F.np_qm31_mul(pows[e - 1], self._alpha)
        self._pows = pows            # alpha^0 .. alpha^CHUNK

    def _accumulate(self, f: Felt):
        self._collected.append(f)
        if len(self._collected) == self.CHUNK:
            self._fold_chunk()

    def _accumulate_vec(self, arr, count: int):
        for b in range(count):
            self._accumulate(Felt(arr[b], "qm31", self.be))

    def _fold_chunk(self):
        k = len(self._collected)
        w = self.be.qconst(self._pows[:k])
        chunk = None
        for j, f in enumerate(self._collected):
            wj = w[k - 1 - j]
            if f.kind == "m31":
                term = F.m31_mul(wj, F._i64(f.v)[..., None])
            else:
                term = F.qm31_mul(wj, f.v)
            chunk = term if chunk is None else chunk + term
        self._collected = []
        chunk = torch.remainder(chunk, F.P)
        if self._total is None:
            self._total = chunk
        else:
            self._total = F.qm31_add(
                F.qm31_mul(self._total, self.be.qconst(self._pows[k])),
                chunk)

    def finalize_acc(self):
        if self._collected:
            self._fold_chunk()
        total, self._total = self._total, None
        self.acc = None if total is None else Felt(total, "qm31", self.be)
        return None if total is None else total

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

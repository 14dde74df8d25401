"""Components and evaluation contexts — the single-source AIR runner.

A ``Component`` declares its main-trace width, optional preprocessed
columns and one ``evaluate(ctx)`` method, which runs under these
contexts:

* ``InfoContext``       — shape collection on 4-row dummy data (numpy).
* ``TapeGenContext`` / ``TapeDomainContext`` (``air/tape.py``) — record
  evaluate() once as an M31 program (a tape) for the interaction
  operands and the composition over the 4x domain; kernel K7
  (generated from each tape, ``air/tape_cuda.py``) runs it over every
  row, or its plain
  interpreter on the CPU.  ``air/tape.py`` builds on this module (the
  contexts' base, the LogUp constraints and pairing, the load roles and
  K6's operand modes); this module does not import it.
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

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops import field as F
from ..utils.device import dev_const
from .expr import Felt, NP
from .lookups import LookupElements

__all__ = [
    "Component", "ComponentInfo", "component_info", "BaseContext",
    "InfoContext", "PointEvalContext", "finalize_logup", "pair_entries",
    "logup_columns", "logup_columns_plain", "run_constraints",
    "preprocessed_is_first", "domain_halo", "MAX_CONSTRAINT_DEG",
    "EVAL_STRIDE",
    "MAIN", "PRE", "INTER", "ISF",
    "M31_CONST", "M31_COL", "QM31_CONST", "QM31_COL",
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

    def jit_key(self):
        """Cache key of the component's tapes: everything ``evaluate``
        bakes in besides the log size and ``params()``."""
        return (type(self), self.name, self.n_main)

    def evaluate(self, ctx):
        raise NotImplementedError


def preprocessed_is_first(log_size: int) -> np.ndarray:
    col = np.zeros(1 << log_size, np.uint32)
    col[0] = 1
    return col


class BaseContext:
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


def pair_entries(entries, be):
    entries = list(entries)
    if len(entries) % 2:
        entries.append((Felt.const(0, be),
                        Felt.qconst(np.array([1, 0, 0, 0]), be)))
    return [(entries[i], entries[i + 1]) for i in range(0, len(entries), 2)]


def finalize_logup(ctx):
    """Emit the LogUp column constraints for the collected entries."""
    if not ctx.entries:
        return
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


class InfoContext(BaseContext):
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
    finalize_logup(ctx)
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


# evaluation rows per trace row on the composition's 4x domain: a mask
# offset o reads 4·o rows away
EVAL_STRIDE = 4


def domain_halo(info: ComponentInfo) -> tuple:
    """(hneg, hpos): the rows a composition pass reads before and after
    its own on the 4x domain, from the component's mask offsets (and the
    LogUp finalize's read of the previous row)."""
    offs = {0, -1 if info.n_logup_cols else 0}
    for masks in (info.masks_main, info.masks_pre, info.masks_inter):
        for offsets in masks.values():
            offs.update(offsets)
    return (EVAL_STRIDE * max(0, -min(offs)), EVAL_STRIDE * max(0, max(offs)))


# operand modes of the LogUp kernel's packed input
M31_CONST, M31_COL, QM31_CONST, QM31_COL = range(4)
# the roles a constraint tape loads from: the main and preprocessed
# matrices, the interaction matrix (row 4b + t is coordinate t of batch
# b) and is_first
MAIN, PRE, INTER, ISF = range(4)


def _operand(src, off: int, mode: int, M: int):
    if mode == M31_CONST:
        return F.qm31_from_m31(src[off:off + 1].to(torch.int64))
    if mode == M31_COL:
        return F.qm31_from_m31(src[off:off + M].to(torch.int64))
    if mode == QM31_CONST:
        return src[off:off + 4].to(torch.int64)[None, :]
    return src[off:off + 4 * M].to(torch.int64).reshape(M, 4)


def logup_columns_plain(src, meta, M: int) -> torch.Tensor:
    """(B, M, 4) int32: S_b = f_0 + .. + f_b for b < B - 1, then the
    prefix sum over rows of the row totals; f_b = (n1·d2 + n2·d1) /
    (d1·d2) for pair b of the packed operands."""
    table = meta.tolist()
    B = len(table[0])
    # the pairs' fractions, as many pairs at a time as fit 2^22 rows (so
    # the int64 temporaries stay within a few hundred MiB), each batch's
    # running sums carried into the next as int32 columns
    step = max(1, (1 << 22) // M)
    cols, running = [], None
    for b0 in range(0, B, step):
        n1, d1, n2, d2 = (torch.stack([
            _operand(src, *table[k][b], M).expand(M, 4)
            for b in range(b0, min(B, b0 + step))]) for k in range(4))
        numer = F.qm31_add(F.qm31_mul(n1, d2), F.qm31_mul(n2, d1))
        # canonical terms over fewer than 2^31 pairs keep the sum exact
        sums = torch.cumsum(
            F.qm31_mul(numer, F.qm31_inv(F.qm31_mul(d1, d2))), dim=0)
        if running is not None:
            sums += running
        sums = torch.remainder(sums, F.P)
        running = sums[-1]
        cols.append(sums.to(torch.int32))
    # the last column is the row totals' prefix sum (exact over fewer
    # than 2^31 rows)
    out = torch.cat(cols)
    out[-1] = torch.remainder(torch.cumsum(running, dim=0), F.P)
    return out


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


# pairs K6 batches under one M31 inverse (kChunk of csrc/logup.cu)
LOGUP_CHUNK = 8


def _meta_on(meta, device) -> torch.Tensor:
    """The device copy of an operand table, kept per table content (a
    tape's table is fixed, so each is copied to the card once)."""
    host = meta.contiguous().numpy()
    key = hashlib.blake2s(host.tobytes()).hexdigest()
    return dev_const(f"logup.meta.{key}", int(host.shape[1]), device,
                     lambda: host)


def logup_columns(src, meta, M: int) -> torch.Tensor:
    """The LogUp columns of the packed pairs (see `logup_operands`; meta
    is a host tensor, copied to the card once per table): launches
    ``csrc/logup.cu`` on a CUDA ``src``, runs `logup_columns_plain` on a
    CPU one."""
    _check_meta(meta, src.numel(), M)
    if src.is_cuda:
        kernels.check_cuda_tensor(src, "operands", ndim=1)
        B = int(meta.shape[1])
        meta_dev = _meta_on(meta, src.device)
        out = torch.empty((B, M, 4), dtype=torch.int32, device=src.device)
        scratch = torch.empty(((M + 255) // 256, 4), dtype=torch.int32,
                              device=src.device)
        kernels.launch("logup_columns", src.data_ptr(), meta_dev.data_ptr(),
                       B, M, out.data_ptr(), scratch.data_ptr(),
                       device=src.device)
        return out
    if src.device.type == "cpu":
        return logup_columns_plain(src, meta, M)
    raise ValueError(f"unsupported device {src.device}")


class PointEvalContext(BaseContext):
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
    finalize_logup(ctx)
    return ctx.acc, ctx.n_constraints

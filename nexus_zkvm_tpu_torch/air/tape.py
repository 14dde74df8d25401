"""Constraint tapes: a component's ``evaluate()`` recorded once as an M31
program and run over every row.

Components write their constraints once against ``Felt`` operators.
Under the ``tape`` backend a payload is a numpy array of node ids (dtype
:data:`ID`), so one run of ``evaluate()`` records the component's whole
expression DAG, one numpy call per ``Felt`` operation whatever its
width (keccak's 1,600-wide vectors included):

* QM31 operations expand into M31 operations on the host, with the
  formulas of ``ops/field.py`` (``qm31 * m31`` is four products), so the
  row program has only load / add / sub / mul / neg.
* Constants fold, and x + 0, x - 0, x * 1 and x * 0 simplify.  A payload
  that is not an ``ID`` array is a constant (keccak wraps a numpy 0/1
  mask as a ``Felt``).
* A node that reads no row is row-independent: the relations' z and
  alpha powers, the claimed sum and the component's integer params enter
  as inputs, and everything
  derived from them and from constants is evaluated once per launch on
  the host into a table of uniforms.  Loads (role, column, offset) and
  constants are deduplicated.

Two contexts record.  :class:`TapeDomainContext` (composition) reads
the 4x evaluation domain and emits one constraint at a time in the
order the verifier accumulates them; :class:`TapeGenContext`
(interaction) outputs the (n1, d1, n2, d2) operands of every LogUp pair
in the packed layout and modes kernel K6 reads.  :func:`domain_tape`
and :func:`gen_tape` cache the compiled tape per (component, log size,
params), so proofs and challenges reuse it.

A compiled :class:`Tape` carries two schedules of the same DAG:

* the kernel's (K7): one instruction stream for every row, ordered
  depth-first from each output so that values die soon after they are
  made, with slots assigned by liveness; loads and uniforms are
  operands, not instructions; constraint j's emit adds alpha^(K-1-j) c_j
  to the accumulator, its weight a table entry.  ``air/tape_cuda.py``
  writes it out as CUDA C++, one statement an instruction (the kernel is
  compiled from each tape, in pieces for a large one);
* the plain interpreter's (:func:`air_eval_plain`): the row-dependent
  nodes grouped by DAG level and opcode, one gather and one op per
  group, over row chunks whose value table fits a memory budget.

The prover reaches the tapes through :func:`generate_interaction` (the
operands, then K6's LogUp columns) and :func:`accumulate_composition`,
whose wrappers launch K7 on CUDA tensors and run the plain interpreter
on CPU ones; :func:`build_kernels` builds a proof's K7 pieces in one
batch before its first launch.  This module builds on
``air/component.py``, which does not import it.

Print every machine component's tape length, slots, loads, uniforms and
K7 pieces with ``python -m nexus_zkvm_tpu_torch.air.tape`` (CPU only),
and a tape's generated source with ``--source NAME [--kind gen]``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from . import tape_cuda
from ..ops import field as F
from ..ops.field import np_qm31, np_qm31_mul
from ..utils.device import dev_const
from ..utils.profile import scope
from .component import (MAIN, PRE, INTER, ISF, EVAL_STRIDE, M31_CONST,
                        M31_COL, QM31_CONST, QM31_COL, BaseContext,
                        finalize_logup, logup_columns, pair_entries,
                        preprocessed_is_first)
from .expr import Felt
from .lookups import LookupElements

__all__ = ["ID", "Tape", "TapeBackend", "TapeDomainContext",
           "TapeGenContext", "domain_tape", "gen_tape", "gen_halo",
           "air_eval_plain",
           "air_eval_composition", "air_eval_composition_plain",
           "composition_uniforms", "constraint_weights",
           "air_eval_operands", "air_eval_operands_plain",
           "interaction_operands", "interaction_columns",
           "generate_interaction",
           "accumulate_composition", "build_kernels",
           "tape_stats"]

P = F.P
ID = np.dtype([("n", np.int64)])          # a payload of node ids

# node kinds; a leaf keeps its constant value, input index or load index
# in ``val``, an operation its operands in ``a`` / ``b`` (b = -1 for neg)
CONST, INPUT, LOAD, ADD, SUB, MUL, NEG = range(7)
# kernel opcodes (the instruction stream air/tape_cuda.py writes out)
K_ADD, K_SUB, K_MUL, K_NEG, K_EMIT1, K_EMITQ_LO, K_EMITQ_HI, K_STORE = \
    range(8)
# operand word: kind in bits 30-31, index below
OPD_SLOT, OPD_UNIFORM, OPD_LOAD = 0, 1 << 30, 2 << 30


def _wrap(ids) -> np.ndarray:
    ids = np.asarray(ids, np.int64)
    out = np.empty(ids.shape, ID)
    out["n"] = ids
    return out


def _fold(op, a, b):
    """Constant folding on int64 canonical values."""
    if op == ADD:
        return (a + b) % P
    if op == SUB:
        return (a - b) % P
    if op == MUL:
        return (a * b) % P
    return (-a) % P


class Recorder:
    """The node arrays of one recording (grown in bulk)."""

    _FIELDS = (("op", np.int8), ("a", np.int64), ("b", np.int64),
               ("val", np.int64), ("lvl", np.int32), ("row", np.bool_))

    def __init__(self):
        self.n, self._cap = 0, 0
        for name, dt in self._FIELDS:
            setattr(self, name, np.zeros(0, dt))
        self._consts: dict = {}        # value -> id
        self.inputs: list = []         # input index -> key
        self._input_ids: dict = {}     # key -> id
        self.loads: list = []          # load index -> (role, col, off)
        self._load_tabs: dict = {}     # (role, off) -> id per column (-1)

    def _new(self, op, a, b, val, lvl, row) -> np.ndarray:
        k = len(a)
        if self.n + k > self._cap:
            cap = max(self.n + k, 2 * self._cap, 4096)
            for name, dt in self._FIELDS:
                arr = np.zeros(cap, dt)
                arr[:self.n] = getattr(self, name)[:self.n]
                setattr(self, name, arr)
            self._cap = cap
        ids = np.arange(self.n, self.n + k)
        self.op[ids], self.a[ids], self.b[ids] = op, a, b
        self.val[ids], self.lvl[ids], self.row[ids] = val, lvl, row
        self.n += k
        return ids

    def trim(self):
        for name, _dt in self._FIELDS:
            setattr(self, name, getattr(self, name)[:self.n])
        self._cap = self.n

    # -- leaves -------------------------------------------------------------
    def consts(self, values) -> np.ndarray:
        v = np.asarray(values).astype(np.int64) % P
        uniq, inv = np.unique(v, return_inverse=True)
        ids = np.empty(len(uniq), np.int64)
        for k, x in enumerate(uniq.tolist()):
            i = self._consts.get(x)
            if i is None:
                i = int(self._new(CONST, [-1], [-1], [x], 0, False)[0])
                self._consts[x] = i
            ids[k] = i
        return ids[inv.reshape(-1)].reshape(v.shape)

    def input(self, key) -> int:
        i = self._input_ids.get(key)
        if i is None:
            i = int(self._new(INPUT, [-1], [-1], [len(self.inputs)], 0,
                              False)[0])
            self.inputs.append(key)
            self._input_ids[key] = i
        return i

    def input_array(self, prefix, shape) -> np.ndarray:
        k = int(np.prod(shape, dtype=np.int64))
        return np.asarray([self.input(prefix + (j,)) for j in range(k)],
                          np.int64).reshape(shape)

    def load(self, role: int, cols, off: int) -> np.ndarray:
        cols = np.asarray(cols, np.int64)
        tab = self._load_tabs.get((role, off), np.zeros(0, np.int64))
        need = int(cols.max()) + 1 if cols.size else 0
        if len(tab) < need:
            tab = np.concatenate([tab, np.full(need - len(tab), -1)])
            self._load_tabs[(role, off)] = tab
        missing = np.unique(cols[tab[cols] < 0])
        if len(missing):
            first = len(self.loads)
            self.loads += [(role, int(c), int(off)) for c in missing]
            tab[missing] = self._new(
                LOAD, np.full(len(missing), -1), np.full(len(missing), -1),
                np.arange(first, first + len(missing)), 0, True)
        return tab[cols]

    # -- operations ---------------------------------------------------------
    def binary(self, op: int, a, b) -> np.ndarray:
        a, b = np.broadcast_arrays(np.asarray(a, np.int64),
                                   np.asarray(b, np.int64))
        shape = a.shape
        a, b = a.ravel(), b.ravel()
        out = np.full(a.size, -1, np.int64)
        ca, cb = self.op[a] == CONST, self.op[b] == CONST
        va, vb = np.where(ca, self.val[a], -1), np.where(cb, self.val[b], -1)
        both = ca & cb
        if both.any():
            out[both] = self.consts(_fold(op, va[both], vb[both]))
        todo = ~both
        if op in (ADD, SUB):
            m = todo & (vb == 0)
            out[m] = a[m]
            todo &= ~m
            m = todo & (va == 0)
            if m.any():
                out[m] = b[m] if op == ADD else self.neg(b[m])
                todo &= ~m
        elif op == MUL:
            m = todo & ((va == 0) | (vb == 0))
            if m.any():
                out[m] = self.consts(0)
                todo &= ~m
            m = todo & (vb == 1)
            out[m] = a[m]
            todo &= ~m
            m = todo & (va == 1)
            out[m] = b[m]
            todo &= ~m
        if todo.any():
            x, y = a[todo], b[todo]
            out[todo] = self._new(op, x, y, -1,
                                  np.maximum(self.lvl[x], self.lvl[y]) + 1,
                                  self.row[x] | self.row[y])
        return out.reshape(shape)

    def neg(self, a) -> np.ndarray:
        a = np.asarray(a, np.int64)
        shape, a = a.shape, a.ravel()
        out = np.full(a.size, -1, np.int64)
        c = self.op[a] == CONST
        if c.any():
            out[c] = self.consts(_fold(NEG, self.val[a[c]], None))
        if (~c).any():
            x = a[~c]
            out[~c] = self._new(NEG, x, np.full(len(x), -1), -1,
                                self.lvl[x] + 1, self.row[x])
        return out.reshape(shape)

    def add(self, a, b):
        return self.binary(ADD, a, b)

    def sub(self, a, b):
        return self.binary(SUB, a, b)

    def mul(self, a, b):
        return self.binary(MUL, a, b)


def _cm31_mul(r, ar, ai, br, bi):
    return (r.sub(r.mul(ar, br), r.mul(ai, bi)),
            r.add(r.mul(ar, bi), r.mul(ai, br)))


def _qm31_mul(r, x, y):
    """(A + B u)(C + D u) = AC + R BD + (AD + BC) u, R = 2 + i, on id
    arrays (..., 4): the formula of ``ops/field.py``."""
    x, y = np.broadcast_arrays(x, y)
    ac = _cm31_mul(r, x[..., 0], x[..., 1], y[..., 0], y[..., 1])
    bd = _cm31_mul(r, x[..., 2], x[..., 3], y[..., 2], y[..., 3])
    ad = _cm31_mul(r, x[..., 0], x[..., 1], y[..., 2], y[..., 3])
    bc = _cm31_mul(r, x[..., 2], x[..., 3], y[..., 0], y[..., 1])
    rb0 = r.sub(r.add(bd[0], bd[0]), bd[1])
    rb1 = r.add(r.add(bd[1], bd[1]), bd[0])
    return np.stack([r.add(ac[0], rb0), r.add(ac[1], rb1),
                     r.add(ad[0], bc[0]), r.add(ad[1], bc[1])], axis=-1)


class TapeBackend:
    """``Felt`` backend whose payloads are node-id arrays (``ID``)."""
    name = "tape"

    def __init__(self, rec: Recorder):
        self.rec = rec

    def ids(self, x) -> np.ndarray:
        """int64 node ids of a payload; a raw number array is a constant."""
        a = np.asarray(x)
        return a["n"] if a.dtype == ID else self.rec.consts(a)

    def m31_add(self, a, b):
        return _wrap(self.rec.add(self.ids(a), self.ids(b)))

    def m31_sub(self, a, b):
        return _wrap(self.rec.sub(self.ids(a), self.ids(b)))

    def m31_mul(self, a, b):
        return _wrap(self.rec.mul(self.ids(a), self.ids(b)))

    def m31_neg(self, a):
        return _wrap(self.rec.neg(self.ids(a)))

    def qm31_mul(self, x, y):
        return _wrap(_qm31_mul(self.rec, self.ids(x), self.ids(y)))

    def qm31_mul_m31(self, q, m):
        return _wrap(self.rec.mul(self.ids(q), self.ids(m)[..., None]))

    def embed(self, m):
        m = self.ids(m)
        z = np.broadcast_to(self.rec.consts(0), m.shape)
        return _wrap(np.stack([m, z, z, z], axis=-1))

    def const(self, x):
        return _wrap(self.rec.consts(int(x) % P))

    def qconst(self, x):
        return _wrap(self.ids(x))


class _TapeCtx(BaseContext):
    """Reads record loads; relations, claimed sum and integer params are
    inputs (the relations' in the order of their names, so a tape and
    its K7 source depend on their names and widths alone)."""
    STRIDE = 1                     # eval rows per trace row

    def __init__(self, relations, params):
        rec = Recorder()
        be = TapeBackend(rec)
        sym = {name: LookupElements(
                   name=name, width=r.width,
                   z=_wrap(rec.input_array(("z", name), (4,))),
                   alpha_pows=_wrap(rec.input_array(("pow", name),
                                                    (r.width, 4))))
               for name, r in sorted(relations.items())}
        super().__init__(be, relations=sym,
                         claimed=_wrap(rec.input_array(("claimed",), (4,))),
                         params=params)
        self.rec = rec

    def _load(self, role, cols, off, kind="m31"):
        return Felt(_wrap(self.rec.load(role, cols, off)), kind, self.be)

    def main(self, i: int, off: int = 0) -> Felt:
        return self._load(MAIN, i, off)

    def main_block(self, lo: int, hi: int, off: int = 0) -> Felt:
        return self._load(MAIN, np.arange(lo, hi), off)

    def pre(self, j: int, off: int = 0) -> Felt:
        return self._load(PRE, j, off)

    @property
    def is_first(self) -> Felt:
        return self._load(ISF, 0, 0)

    def param(self, name: str) -> Felt:
        """An integer parameter enters the uniform table, not the program
        as a constant, so a component's tape and K7's source are the same
        for every value (every guest program's addresses)."""
        if isinstance(self._params[name], (int, np.integer)):
            return Felt(_wrap(self.rec.input(("param", name))), "m31",
                        self.be, deg=0)
        return super().param(name)


class TapeDomainContext(_TapeCtx):
    """Composition: every constraint is an EMIT, in evaluate() order and
    then the LogUp constraints of `finalize_logup`."""
    accumulates = True
    STRIDE = EVAL_STRIDE

    def __init__(self, relations, params):
        super().__init__(relations, params)
        self.emits = []            # (k, 4) node-id blocks

    def inter(self, b: int, off: int = 0) -> Felt:
        return self._load(INTER, 4 * b + np.arange(4), off, "qm31")

    def _accumulate(self, f: Felt):
        self.emits.append(self.be.ids(f.as_qm31().v).reshape(1, 4))

    def _accumulate_vec(self, arr, count: int):
        ids = self.be.ids(arr if isinstance(arr, np.ndarray)
                          else np.asarray(list(arr)))
        self.emits.append(ids.reshape(count, 4))


class TapeGenContext(_TapeCtx):
    """Interaction: collects the LogUp fractions."""

    def inter(self, b, off=0):
        raise RuntimeError("interaction columns not available during gen")


# ---------------------------------------------------------------------------
# The compiled tape
# ---------------------------------------------------------------------------

@dataclass
class Tape:
    """One component's compiled tape (see the module docstring)."""
    kind: str                  # "domain" | "gen"
    stride: int                # load offsets are multiplied by it
    n_constraints: int
    loads: np.ndarray          # (L, 3) role, column, offset
    inputs: list               # key of every input leaf of the uniform graph
    program: np.ndarray        # (I, 4) int32 kernel instructions
    n_slots: int
    n_nodes: int               # reachable nodes (all kinds)
    # host evaluation of the uniforms: compact value space over the
    # reachable row-independent nodes
    u_const: tuple             # (positions, values) of constants
    u_input: np.ndarray        # positions of inputs, in ``inputs`` order
    u_groups: list             # (op, lo, hi, a, b) by level
    u_table: np.ndarray        # positions of the uniform table entries
    u_size: int
    # plain interpreter: value space = [uniform table | loads | row ops]
    p_groups: list             # (op, lo, hi, a, b) by level
    p_size: int
    emits: np.ndarray          # (K, 4) value indices (domain)
    # (S, 4) value index, a, b, step of each store (gen): its word base
    # a·rows + b for a buffer of ``rows`` rows (`layout`)
    store_terms: np.ndarray
    modes: torch.Tensor = None  # (4, B) K6 operand modes (gen)
    name: str = ""             # the component's
    params: dict = None        # the component's, the "param" inputs' values
    _dev: dict = field(default_factory=dict, repr=False)

    def layout(self, rows: int) -> tuple:
        """A gen tape's packed operand buffer laid out for ``rows`` rows
        (the whole trace, or a mesh rank's window of it): (stores, (S, 3)
        value index, word base a·rows + b of ``store_terms``, step; K6's
        (4, B, 2) host operand table; the buffer's words).  The buffer
        holds each operand in ``meta``'s order, a column's ``rows`` or
        4·``rows`` words, a constant's 1 or 4, so only the offsets move
        with ``rows``; cached per row count."""
        key = ("layout", int(rows))
        got = self._dev.get(key)
        if got is None:
            t = self.store_terms
            stores = np.stack([t[:, 0], t[:, 1] * rows + t[:, 2], t[:, 3]],
                              axis=1)
            modes = self.modes.reshape(-1)
            words = torch.tensor([1, rows, 4, 4 * rows])[modes]
            meta = torch.stack([torch.cumsum(words, 0) - words, modes],
                               dim=-1).reshape(*self.modes.shape, 2)
            got = self._dev.setdefault(key, (stores, meta,
                                             int(words.sum())))
        return got

    def halo(self) -> tuple:
        """(hneg, hpos): the rows before and after its own that a row's
        loads read (load offsets times the stride)."""
        offs = self.loads[:, 2] * self.stride
        if not len(offs):
            return 0, 0
        return max(0, -int(offs.min())), max(0, int(offs.max()))

    def uniforms(self, relations, claimed) -> np.ndarray:
        """(U,) int64 uniform table for these challenges (and the params
        the tape was recorded with)."""
        v = np.zeros(self.u_size, np.int64)
        pos, vals = self.u_const
        v[pos] = vals
        for p, key in zip(self.u_input.tolist(), self.inputs):
            if key[0] == "claimed":
                v[p] = int(np.asarray(claimed).reshape(-1)[key[1]])
            elif key[0] == "param":
                v[p] = int(self.params[key[1]]) % P
            else:
                r = relations[key[1]]
                src = r.z if key[0] == "z" else r.alpha_pows
                v[p] = int(np.asarray(src).reshape(-1)[key[2]])
        v %= P
        for op, lo, hi, a, b in self.u_groups:
            v[lo:hi] = _fold(op, v[a], None if b is None else v[b])
        return v[self.u_table]


def _reachable(rec: Recorder, roots) -> np.ndarray:
    reach = np.zeros(rec.n, bool)
    front = np.unique(np.asarray(roots, np.int64))
    while front.size:
        reach[front] = True
        a, b = rec.a[front], rec.b[front]
        nxt = np.concatenate([a[a >= 0], b[b >= 0]])
        nxt = np.unique(nxt)
        front = nxt[~reach[nxt]]
    return reach


def _level_order(rec, nodes) -> np.ndarray:
    """Op nodes sorted by (DAG level, opcode)."""
    return nodes[np.lexsort((rec.op[nodes], rec.lvl[nodes]))]


def _group_list(order, rec, index, base):
    """[(op, lo, hi, a, b)] for runs of one (level, opcode) in ``order``,
    which occupies value positions base.. ; operands through ``index``
    (node -> value position)."""
    out = []
    if not len(order):
        return out
    key = rec.lvl[order].astype(np.int64) * 8 + rec.op[order]
    cuts = np.flatnonzero(np.diff(key)) + 1
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(order)]):
        nodes = order[lo:hi]
        op = int(rec.op[nodes[0]])
        a = index[rec.a[nodes]]
        b = None if op == NEG else index[rec.b[nodes]]
        out.append((op, base + int(lo), base + int(hi), a, b))
    return out


def _schedule(rec: Recorder, reach, outputs):
    """The kernel's instruction stream: depth-first post-order from each
    output (a list of (opcode, dst, operand nodes)); returns the order of
    row-op nodes and the output positions interleaved."""
    is_op = reach & rec.row & (rec.op >= ADD)
    a_l, b_l, op_ok = rec.a.tolist(), rec.b.tolist(), is_op.tolist()
    done = bytearray(rec.n)
    seq = []                              # node id, or ~output index
    for k, (_code, _dst, opnds) in enumerate(outputs):
        for r in opnds:
            if not op_ok[r] or done[r]:
                continue
            stack = [r]
            while stack:
                x = stack[-1]
                if done[x]:
                    stack.pop()
                    continue
                pushed = False
                for y in (a_l[x], b_l[x]):
                    if y >= 0 and op_ok[y] and not done[y]:
                        stack.append(y)
                        pushed = True
                if not pushed:
                    done[x] = 1
                    seq.append(x)
                    stack.pop()
        seq.append(~k)
    return seq


def _kernel_program(rec: Recorder, seq, rowop, word, outputs,
                    n_uniforms: int):
    """The (I, 4) int32 instructions of the stream ``seq`` and its slot
    count: a row-op value takes a free slot when it is made and frees it
    after its last use (an instruction reads its operands before it
    writes, so its destination may reuse an operand's slot).  Constraint
    j's emit carries the table index of its weight alpha^(K-1-j), four
    words at n_uniforms + 4j (the composition wrapper appends the
    weights to the uniforms)."""
    a_l, b_l, row_op = rec.a.tolist(), rec.b.tolist(), rowop.tolist()

    def operands(x):
        return (a_l[x], b_l[x]) if x >= 0 else tuple(outputs[~x][2])

    last = {}
    for i, x in enumerate(seq):
        for y in operands(x):
            if y >= 0 and row_op[y]:
                last[y] = i
    slot, free, n_slots, prog = {}, [], 0, []

    def w(y):
        return slot[y] if row_op[y] else int(word[y])

    for i, x in enumerate(seq):
        for y in set(operands(x)):
            if y >= 0 and row_op[y] and last[y] == i:
                free.append(slot[y])
        if x >= 0:
            if free:
                s = free.pop()
            else:
                s, n_slots = n_slots, n_slots + 1
            slot[x] = s
            op = int(rec.op[x])
            code = {ADD: K_ADD, SUB: K_SUB, MUL: K_MUL, NEG: K_NEG}[op]
            prog.append((code, s, w(a_l[x]),
                         0 if op == NEG else w(b_l[x])))
        else:
            code, dst, opnds = outputs[~x]
            ws = [w(y) for y in opnds]
            if code == K_EMITQ_LO:
                prog.append((K_EMITQ_LO, 0, ws[0], ws[1]))
                prog.append((K_EMITQ_HI, n_uniforms + 4 * dst, ws[2],
                             ws[3]))
            elif code == K_EMIT1:
                prog.append((K_EMIT1, n_uniforms + 4 * dst, ws[0], 0))
            else:
                prog.append((code, dst, ws[0], 0))
    program = np.asarray(prog, np.int64).reshape(-1, 4) \
        .astype(np.uint32).view(np.int32)
    return np.ascontiguousarray(program), n_slots


def _compile(rec: Recorder, kind: str, stride: int, outputs,
             n_constraints: int, name: str, params: dict, emits=None,
             stores=None, modes=None) -> Tape:
    """outputs: [(kernel opcode, constraint or store index, operand node
    ids)] in order."""
    rec.trim()
    roots = [x for _c, _d, opnds in outputs for x in opnds]
    reach = _reachable(rec, roots) if roots else np.zeros(rec.n, bool)
    ops = rec.op
    rowop = reach & rec.row & (ops >= ADD)
    uni = reach & ~rec.row
    load_nodes = np.flatnonzero(reach & (ops == LOAD))

    # the uniform table: row-independent operands of row ops and outputs
    rn = np.flatnonzero(rowop)
    used = np.concatenate([rec.a[rn], rec.b[rn], np.asarray(roots,
                                                             np.int64)])
    used = used[used >= 0]
    table = np.unique(used[uni[used]])

    # host evaluation of every reachable row-independent node
    un = np.flatnonzero(uni)
    leaves = un[ops[un] < ADD]
    u_order = _level_order(rec, un[ops[un] >= ADD])
    upos = np.full(rec.n, -1, np.int64)
    upos[leaves] = np.arange(len(leaves))
    upos[u_order] = len(leaves) + np.arange(len(u_order))
    consts = leaves[ops[leaves] == CONST]
    inputs = leaves[ops[leaves] == INPUT]
    u_groups = _group_list(u_order, rec, upos, len(leaves))

    # kernel: operand words of uniforms and loads, then the stream
    word = np.zeros(rec.n, np.int64)
    word[table] = OPD_UNIFORM | np.arange(len(table))
    word[load_nodes] = OPD_LOAD | np.arange(len(load_nodes))
    program, n_slots = _kernel_program(rec, _schedule(rec, reach, outputs),
                                       rowop, word, outputs, len(table))

    # plain: value space [uniform table | loads | row ops by level]
    vpos = np.full(rec.n, -1, np.int64)
    vpos[table] = np.arange(len(table))
    base = len(table) + len(load_nodes)
    vpos[load_nodes] = len(table) + np.arange(len(load_nodes))
    p_order = _level_order(rec, rn)
    vpos[p_order] = base + np.arange(len(p_order))
    p_groups = _group_list(p_order, rec, vpos, base)

    loads = np.asarray([rec.loads[int(v)] for v in rec.val[load_nodes]],
                       np.int64).reshape(-1, 3)
    return Tape(
        kind=kind, stride=stride, n_constraints=n_constraints, loads=loads,
        inputs=[rec.inputs[int(v)] for v in rec.val[inputs]],
        program=program, n_slots=n_slots,
        n_nodes=int(reach.sum()),
        u_const=(upos[consts], rec.val[consts].copy()),
        u_input=upos[inputs], u_groups=u_groups, u_table=upos[table],
        u_size=len(un), p_groups=p_groups, p_size=base + len(p_order),
        emits=(vpos[emits] if emits is not None
               else np.zeros((0, 4), np.int64)),
        store_terms=(np.concatenate([vpos[stores[:, :1]], stores[:, 1:]],
                                    axis=1)
                     if stores is not None else np.zeros((0, 4), np.int64)),
        modes=modes, name=name, params=params)


def _record_domain(component, relations) -> Tape:
    ctx = TapeDomainContext(relations, component.params())
    component.evaluate(ctx)
    finalize_logup(ctx)
    if not ctx.emits:
        return None
    emits = np.concatenate(ctx.emits)
    zero = ctx.rec.consts(0)
    outputs = []
    for j, e in enumerate(emits.tolist()):
        if e[1] == e[2] == e[3] == int(zero):
            outputs.append((K_EMIT1, j, tuple(e)))
        else:
            outputs.append((K_EMITQ_LO, j, tuple(e)))
    return _compile(ctx.rec, "domain", ctx.STRIDE, outputs,
                    ctx.n_constraints, component.name, component.params(),
                    emits=emits)


def _record_gen(component, relations) -> Tape:
    """The operand packing of `logup_operands` in the eager port: for k
    in (n1, d1, n2, d2), for every pair, its piece of the buffer (at word
    off_m·rows + off_c of a buffer of ``rows`` rows, `Tape.layout`)."""
    ctx = TapeGenContext(relations, component.params())
    component.evaluate(ctx)
    if not ctx.entries:
        return None
    rec, be = ctx.rec, ctx.be
    pairs = pair_entries(ctx.entries, be)
    modes, stores, outputs = [], [], []
    off_m, off_c = 0, 0
    for k in range(4):
        for pair in pairs:
            f = pair[k // 2][k % 2]
            ids = be.ids(f.v).reshape(-1)
            row = bool(rec.row[ids].any())
            if f.kind == "m31":
                mode, width, coords = ((M31_COL, 1, [(ids[0], 0, 1)]) if row
                                       else (M31_CONST, 1, [(ids[0], 0, 0)]))
            else:
                mode, width = (QM31_COL if row else QM31_CONST), 4
                coords = [(ids[t], t, 4 if row else 0) for t in range(4)]
            for node, t, step in coords:
                outputs.append((K_STORE, len(stores), (int(node),)))
                stores.append((int(node), off_m, off_c + t, step))
            modes.append(mode)
            if row:
                off_m += width
            else:
                off_c += width
    return _compile(rec, "gen", ctx.STRIDE, outputs, 0, component.name,
                    component.params(),
                    stores=np.asarray(stores, np.int64).reshape(-1, 4),
                    modes=torch.tensor(modes, dtype=torch.int64)
                    .reshape(4, len(pairs)))


_CACHE: dict = {}
_LOCK = threading.Lock()


def _cached(kind, component, log_size, relations, build):
    key = (kind, component.jit_key(), int(log_size),
           tuple(sorted(component.params().items())))
    with _LOCK:
        if key in _CACHE:
            return _CACHE[key]
    tape = build()
    with _LOCK:
        _CACHE[key] = tape
    return tape


def gen_halo(component, log_size: int, widths: dict) -> tuple:
    """(hneg, hpos) of a component's gen tape (`Tape.halo`; (0, 0)
    without lookups), before any relation is drawn: a tape depends on
    its relations' names and widths (``widths``), not on their values,
    so it is recorded here with stand-ins and cached for the proof."""
    tape = gen_tape(component, log_size,
                    {name: LookupElements.dummy(name, w)
                     for name, w in widths.items()})
    return (0, 0) if tape is None else tape.halo()


def domain_tape(component, log_size: int, relations) -> Tape | None:
    """The composition tape of a component (None without constraints),
    cached per (component, log size, params)."""
    return _cached("domain", component, log_size, relations,
                   lambda: _record_domain(component, relations))


def gen_tape(component, log_size: int, relations) -> Tape | None:
    """The interaction tape (None for a component without lookups)."""
    return _cached("gen", component, log_size, relations,
                   lambda: _record_gen(component, relations))


# ---------------------------------------------------------------------------
# The plain interpreter
# ---------------------------------------------------------------------------

_OPS = {ADD: F.m31_add, SUB: F.m31_sub, MUL: F.m31_mul}
# value-table elements per row chunk: (values) x (rows) int64
_BUDGET = {"cpu": 1 << 25, "cuda": 1 << 29}


def constraint_weights(alpha, K: int) -> np.ndarray:
    """(K, 4) uint64 alpha^(K-1-j) for j < K: constraint j's weight in
    the verifier's Horner sum (powers by doubling, one numpy product
    per doubling)."""
    pows = np_qm31(np.ones(1, np.uint64))          # alpha^0
    a = np.asarray(alpha, np.uint64)
    while len(pows) < K:
        pows = np.concatenate([pows, np_qm31_mul(pows, a)])
        a = np_qm31_mul(a, a)
    return np.ascontiguousarray(pows[:K][::-1])


def air_eval_plain(tape: Tape, mats: dict, uniforms: np.ndarray, N: int,
                   alpha=None, out: torch.Tensor = None,
                   hneg: int = 0) -> torch.Tensor:
    """Interpret ``tape`` over N rows with torch int64.

    mats: role -> (cols, W) int32 matrix (is_first as a (1, W) one), a
    load at row r reading position (r + hneg + shift) mod W: the trace's
    own columns (W = N, hneg 0: the wrap is the reference's roll), or a
    window's halo-extended blocks (every load inside them).  uniforms:
    the table of :meth:`Tape.uniforms`.  A domain tape returns the (N, 4)
    int64 canonical accumulator sum_j alpha^(K-1-j) c_j; a gen tape
    writes the packed operand buffer of N rows (:meth:`Tape.layout`)
    ``out`` (int32) and returns it."""
    dev = _first(mats).device
    W = int(_first(mats).shape[1])
    U = len(uniforms)
    uni = torch.as_tensor(np.asarray(uniforms, np.int64), device=dev)
    L = len(tape.loads)
    budget = _BUDGET.get(dev.type, 1 << 25)
    chunk = max(1, min(N, 1 << max(0, (budget // max(1, tape.p_size))
                                   .bit_length() - 1)))
    loads = torch.as_tensor(tape.loads, device=dev)
    if tape.kind == "domain":
        K = len(tape.emits)
        w = torch.as_tensor(constraint_weights(alpha, K).astype(np.int64),
                            device=dev)
        emits = torch.as_tensor(tape.emits, device=dev)
        acc = torch.empty((N, 4), dtype=torch.int64, device=dev)
    else:
        st = torch.as_tensor(tape.layout(N)[0], device=dev)
        col = st[:, 2] != 0
        st_col, st_one = st[col], st[~col]
    for r0 in range(0, N, chunk):
        rows = torch.arange(r0, min(N, r0 + chunk), device=dev)
        V = torch.empty((tape.p_size, len(rows)), dtype=torch.int64,
                        device=dev)
        V[:U] = uni[:, None]
        for role in range(4):
            sel = torch.nonzero(loads[:, 0] == role).reshape(-1)
            if sel.numel():
                idx = (rows[None, :] + hneg
                       + tape.stride * loads[sel, 2:3]) % W
                V[U + sel] = mats[role][loads[sel, 1:2], idx].to(torch.int64)
        for op, lo, hi, a, b in tape.p_groups:
            a = torch.as_tensor(a, device=dev)
            if op == NEG:
                V[lo:hi] = F.m31_neg(V[a])
            else:
                V[lo:hi] = _OPS[op](V[a], V[torch.as_tensor(b, device=dev)])
        if tape.kind == "domain":
            part = torch.zeros((len(rows), 4), dtype=torch.int64, device=dev)
            for j0 in range(0, K, 256):
                c = V[emits[j0:j0 + 256]].permute(0, 2, 1)   # (k, R, 4)
                part += F.qm31_mul(w[j0:j0 + 256, None, :], c).sum(dim=0)
            acc[r0:r0 + len(rows)] = torch.remainder(part, P)
        else:
            vals = V[st_col[:, 0]]
            pos = st_col[:, 1:2] + st_col[:, 2:3] * rows[None, :]
            out[pos.reshape(-1)] = vals.reshape(-1).to(torch.int32)
            if r0 == 0 and st_one.numel():
                out[st_one[:, 1]] = V[st_one[:, 0], 0].to(torch.int32)
    return acc if tape.kind == "domain" else out


# ---------------------------------------------------------------------------
# Kernel K7 (generated from each tape: air/tape_cuda.py,
# csrc/air_eval_gen.cuh), its plain versions, and the prover's calls
# ---------------------------------------------------------------------------

def _role_cols(tape) -> np.ndarray:
    """(4,) the number of columns each role's loads need (0: none)."""
    got = tape._dev.get("role_cols")
    if got is None:
        got = np.zeros(4, np.int64)
        for role in range(4):
            cols = tape.loads[tape.loads[:, 0] == role, 1]
            got[role] = int(cols.max()) + 1 if len(cols) else 0
        tape._dev["role_cols"] = got
    return got


def _bases(tape, mats) -> list:
    """The four role pointers of a K7 launch (an absent role, which no
    load reads, points at the first matrix)."""
    need = _role_cols(tape)
    out = []
    for role in range(4):
        m = mats.get(role)
        rows = 0 if m is None else int(m.shape[0])
        if need[role] > rows:
            raise ValueError("a tape load lies outside its matrix")
        out.append((_first(mats) if m is None else m).data_ptr())
    return out


def _check_mats(mats, N: int, device) -> None:
    for role, m in mats.items():
        if m is None:
            continue
        if m.device != device:
            raise ValueError(f"matrix of role {role} on {m.device}, "
                             f"expected {device}")
        if m.is_cuda:
            kernels.check_cuda_tensor(m, f"role {role} matrix", ndim=2)
        if m.shape[1] != N:
            raise ValueError(f"matrix of role {role} has {m.shape[1]} "
                             f"rows, expected {N}")


def _first(mats) -> torch.Tensor:
    return next(m for m in mats.values() if m is not None)


def air_eval_operands_plain(tape, mats, uniforms, N: int, lo: int = 0,
                            L: int = None, hneg: int = 0) -> torch.Tensor:
    """K7's operands epilogue in plain torch (the tape interpreter)."""
    L = N if L is None else L
    out = torch.empty(tape.layout(L)[2], dtype=torch.int32,
                      device=_first(mats).device)
    return air_eval_plain(tape, mats, uniforms, L, out=out, hneg=hneg)


def air_eval_operands(tape, mats, uniforms, N: int, lo: int = 0,
                      L: int = None, hneg: int = 0) -> torch.Tensor:
    """The packed LogUp operands of a gen tape over rows [lo, lo + L) of
    its N-row trace (all of them for L None), laid out for L rows
    (:meth:`Tape.layout`): launches K7 (the tape's generated pieces) on
    CUDA matrices, runs `air_eval_operands_plain` on CPU ones.  mats:
    load role -> int32 matrix (or None): the (cols, N) trace itself for
    the whole (a load wraps), else halo-extended (cols, W) blocks whose
    position q holds row lo - hneg + q (mod N), every load inside them,
    as `air_eval_composition` reads them."""
    dev = _first(mats).device
    W = int(_first(mats).shape[1])
    _check_mats(mats, W, dev)
    L = N if L is None else int(L)
    shifts = tape.loads[:, 2] * tape.stride
    if L == N:
        bad = lo != 0 or hneg != 0 or W != N
    else:
        bad = lo < 0 or L <= 0 or lo + L > N or (len(shifts) > 0 and (
            hneg + shifts.min() < 0 or L + hneg + shifts.max() > W))
    if bad:
        raise ValueError(f"rows [{lo}, {lo + L}) of {N}, halo {hneg}, "
                         f"blocks of {W}: a load falls outside")
    if _first(mats).is_cuda:
        out = torch.empty(tape.layout(L)[2], dtype=torch.int32, device=dev)
        tape_cuda.launch(tape, uniforms, _bases(tape, mats),
                         (W, L, hneg, N - 1 if L == N else -1,
                          out.data_ptr()), dev)
        return out
    if dev.type == "cpu":
        return air_eval_operands_plain(tape, mats, uniforms, N, lo, L, hneg)
    raise ValueError(f"unsupported device {dev}")


def air_eval_composition_plain(tape, mats, uniforms, lo: int, L: int,
                               hneg: int, alpha, shift, invv,
                               bucket) -> None:
    """K7's composition in plain torch: bucket[lo:lo + L] += acc *
    invv[lo:lo + L] * shift, acc from the tape interpreter over the
    window's halo-extended blocks."""
    acc = air_eval_plain(tape, mats, uniforms, L, alpha=alpha, hneg=hneg)
    sh = torch.as_tensor(np.asarray(shift, np.int64), device=acc.device)
    contrib = F.qm31_mul(sh, F.qm31_mul_m31(acc, invv[lo:lo + L]))
    window = bucket[lo:lo + L]
    window.copy_(F.m31_add(window, contrib).to(torch.int32))


def composition_uniforms(tape, uniforms, alpha) -> np.ndarray:
    """K7's composition table after the loads: the uniforms, then every
    constraint's weight alpha^(K-1-j) (four words each, where the emits
    of the program point)."""
    return np.concatenate([
        np.asarray(uniforms, np.int64),
        constraint_weights(alpha, len(tape.emits)).astype(np.int64)
        .reshape(-1)])


def air_eval_composition(tape, mats, uniforms, lo: int, L: int, hneg: int,
                         alpha, shift, invv: torch.Tensor,
                         bucket: torch.Tensor) -> None:
    """bucket[lo:lo + L] += (sum_j alpha^(K-1-j) c_j) * invv * shift over
    rows [lo, lo + L) of the N-row domain, in place: c_j the tape's
    constraints, invv the (N,) 1 / v_n, bucket (N, 4) int32.  mats: role
    -> halo-extended (cols, W) blocks whose position q holds natural row
    lo - hneg + q (mod N); every load must fall inside them (a resident
    composition is the one window [0, N)).  Launches K7 (the tape's
    generated pieces, one after another) on CUDA matrices, runs
    `air_eval_composition_plain` on CPU ones."""
    dev = _first(mats).device
    W = int(_first(mats).shape[1])
    _check_mats(mats, W, dev)
    N = int(bucket.shape[0])
    shifts = tape.loads[:, 2] * tape.stride
    if tuple(bucket.shape) != (N, 4) or tuple(invv.shape) != (N,) or \
            lo < 0 or L <= 0 or lo + L > N or (len(shifts) and (
                hneg + shifts.min() < 0 or L + hneg + shifts.max() > W)):
        raise ValueError(f"rows [{lo}, {lo + L}) of {N}, halo {hneg}, "
                         f"blocks of {W}: a load falls outside")
    if _first(mats).is_cuda:
        kernels.check_cuda_tensor(invv, "invv", ndim=1)
        kernels.check_cuda_tensor(bucket, "bucket", ndim=2)
        tape_cuda.launch(
            tape, composition_uniforms(tape, uniforms, alpha),
            _bases(tape, mats),
            (W, lo, L, hneg, *(int(x) for x in np.asarray(shift, np.uint64)),
             invv.data_ptr(), bucket.data_ptr()), dev)
        return
    if dev.type == "cpu":
        air_eval_composition_plain(tape, mats, uniforms, lo, L, hneg, alpha,
                                   shift, invv, bucket)
        return
    raise ValueError(f"unsupported device {dev}")


def _is_first_matrix(log_size: int, device, lo: int = 0, W: int = None,
                     hneg: int = 0) -> torch.Tensor:
    """is_first as a (1, 2^log_size) matrix, or as the (1, W) block of a
    window (position q: row lo - hneg + q, mod 2^log_size)."""
    if W is None:
        return dev_const("component.is_first", log_size, device,
                         lambda: preprocessed_is_first(log_size)[None, :])
    rows = (torch.arange(W, device=device) + (lo - hneg)) % (1 << log_size)
    return (rows == 0).to(torch.int32)[None, :]


def interaction_operands(component, main_matrix, pre_matrix, relations,
                         log_size: int, device, window: tuple = None):
    """The packed LogUp operands of a component (its gen tape; kernel K7
    on a CUDA device) from its natural-order main and preprocessed
    matrices: the whole (C, M) trace, or for ``window`` = (lo, L, hneg)
    halo-extended (C, W) blocks whose position q holds row lo - hneg + q
    (mod M), every load of the tape inside them.  Returns (operands, K6's
    operand table, rows), the buffer laid out for L rows (M for the
    whole), or None for a component without lookups."""
    M = 1 << log_size
    tape = gen_tape(component, log_size, relations)
    if tape is None:
        return None
    lo, L, hneg = (0, M, 0) if window is None else window
    given = main_matrix if main_matrix is not None else pre_matrix
    W = (None if window is None else int(given.shape[1])
         if given is not None else hneg + L + tape.halo()[1])
    mats = {MAIN: main_matrix, PRE: pre_matrix,
            ISF: _is_first_matrix(log_size, device, lo, W, hneg)}
    src = air_eval_operands(tape, mats, tape.uniforms(relations, None), M,
                            *(() if window is None else window))
    return src, tape.layout(L)[1], L


def generate_interaction(component, main_matrix, pre_matrix, relations,
                         log_size: int, device):
    """The LogUp columns of a component from its natural-order (C, M)
    main and preprocessed matrices: its gen tape gives the packed pair
    operands (`interaction_operands`: kernel K7 on a CUDA device),
    kernel K6 the columns (`interaction_columns`).

    Returns ((B, M, 4) int32 natural-order columns, (4,) claimed sum
    tensor), or (None, None) for a component without lookups."""
    with scope("i:eval"):
        got = interaction_operands(component, main_matrix, pre_matrix,
                                   relations, log_size, device)
    if got is None:
        return None, None
    out = interaction_columns(got)
    return out, out[-1, -1]


def interaction_columns(operands: tuple, carry=None) -> torch.Tensor:
    """Kernel K6 on `interaction_operands`' result: the (B, L, 4) LogUp
    columns, the last one's prefix sum starting from ``carry``."""
    with scope("i:logup"):
        return logup_columns(*operands,
                             *(() if carry is None else (carry,)))


def accumulate_composition(component, log_size: int, mats, relations,
                           claimed, alpha, shift, invv, bucket,
                           window: tuple) -> int:
    """Add a component's composition block, acc / v_n * shift, over the
    rows ``window`` = (lo, hi, hneg) of its 4x domain into its eval
    size's bucket; mats: role -> halo-extended blocks of its natural
    evaluations (`air_eval_composition`; interaction as the
    coordinate-major (4B, W) matrix, is_first as (1, W)).  Returns the
    constraint count."""
    tape = domain_tape(component, log_size, relations)
    if tape is None:
        return 0
    lo, hi, hneg = window
    air_eval_composition(tape, mats, tape.uniforms(relations, claimed), lo,
                         hi - lo, hneg, alpha, shift, invv, bucket)
    return tape.n_constraints


def build_kernels(components, log_sizes, relations) -> dict:
    """Record every component's two tapes and build their K7 pieces that
    are not loaded yet, in one batch (one ``nvcc`` a piece, as many at
    once as the machine has CPUs); returns the build's record
    (`kernels.build_generated`)."""
    tapes = [t for comp, n in zip(components, log_sizes)
             for t in (domain_tape(comp, n, relations),
                       gen_tape(comp, n, relations)) if t is not None]
    return tape_cuda.build(tapes)


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def tape_stats(component, log_size: int, relations) -> dict:
    """Instruction count, slot count, loads, uniforms, outputs and K7
    pieces of a component's two tapes."""
    out = {"name": component.name, "log_size": log_size}
    for kind, tape in (("domain", domain_tape(component, log_size,
                                              relations)),
                       ("gen", gen_tape(component, log_size, relations))):
        if tape is None:
            continue
        out[kind] = {"instructions": len(tape.program),
                     "slots": tape.n_slots, "loads": len(tape.loads),
                     "uniforms": len(tape.u_table), "nodes": tape.n_nodes,
                     "outputs": (len(tape.emits) if kind == "domain"
                                 else len(tape.store_terms)),
                     "pieces": len(tape_cuda.pieces(tape))}
    return out


def _main():
    """Tape statistics of every component of the fib guest's machine
    proof at n = 10 (the tapes depend on the component and its params,
    not on the trace size); with ``--source NAME``, the generated K7
    source of that component's tape instead (every piece)."""
    import argparse
    import json
    from pathlib import Path
    from .component import component_info
    from .lookups import draw_relations
    from ..channel import Blake2sChannel
    from ..machine.driver import build_components
    from ..prover.stark import _relation_widths
    from ..sdk import Guest, LocalProver, encode_u32s
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", metavar="NAME",
                    help="print the generated K7 source of this component")
    ap.add_argument("--kind", choices=("domain", "gen"), default="domain")
    args = ap.parse_args()
    src = (Path(__file__).resolve().parents[2] / "examples" / "guests"
           / "fib.s").read_text()
    view, trace = LocalProver(Guest.from_asm(src), device="cpu").trace(
        public_input=encode_u32s(10))
    comps = build_components(view, 1)[0]
    relations = draw_relations(Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))
    if args.source is None:
        for c in comps:
            print(json.dumps(tape_stats(c, 5, relations)))
        return
    comp = next(c for c in comps if c.name == args.source)
    tape = (domain_tape if args.kind == "domain" else gen_tape)(
        comp, 5, relations)
    for piece in tape_cuda.pieces(tape):
        print(piece.text)


if __name__ == "__main__":
    _main()

"""Per-instruction-family execution components (machine2).

Each family component proves the semantics of a small opcode group over
its own trace of 2^log rows (one row per executed step of that group,
compacted in execution order, padded with `pad`-flagged rows).  The
cross-family glue is entirely relational:

* `prog`  — fetch: (pc, opid, op_a, op_b, op_c, imm_lo, imm_hi) looked
  up in the preprocessed program table (shared with machine v1).
* `exec`  — execution chain: every real row consumes (clk, pc) and
  emits (clk+1, next_pc); the syscall family additionally emits the
  boundary state (1, entry) on its first row and withholds the emit on
  the halting row, so the chain is a single path from entry to halt.
  (Reference analogue: CpuBoundary + ProgramExecution relation,
  `nexus-zkvm/prover2/machine/src/components/`.)
* `reg` / `mem` — the register-file and RAM multiset protocols of
  `machine/memside.py`, identical tuples and timestamp discipline
  (ts = 3*clk + slot) as the monolithic CPU.

Design notes (vs `machine/cpu.py`):

* **No committed next-pc.**  Families with sequential control flow emit
  (clk+1, pcW + 4) directly; branches/jumps emit an arithmetic target
  expression.  2^32 = 2 (mod M31), so an unconstrained wrap bit can
  only shift the emitted target by +-2 — never reaching another
  word-aligned program pc (< 2^30) — and the immediate's sign bit is
  pinned by a committed decomposition, making the target expression
  exact for every in-range execution.
* **Entry pairing is degree-aware.**  LogUp batches fractions in pairs;
  value expressions of degree 2 (exec targets, effective write values)
  are ordered so they always share a batch with a degree<=1 partner,
  keeping every constraint within MAX_CONSTRAINT_DEG.
"""

from __future__ import annotations

import numpy as np

from ..air import Component
from ..vm.isa import Opcode, SyscallCode
from ..machine.schema import Schema, Cols
from ..machine.cpu import _bytes4, _limbs, _inv_or_zero

__all__ = ["EXEC_FAMILIES", "family_rows", "fill_family"]


def _sum(fs):
    acc = fs[0]
    for f in fs[1:]:
        acc = acc + f
    return acc


# ---------------------------------------------------------------------------
# Schema blocks
# ---------------------------------------------------------------------------

def _common_spec(n_flags: int):
    return [
        ("f", n_flags), ("pad", 1), ("clk", 1),
        ("pc", 4), ("imm", 4),
        ("opa", 1), ("opb", 1), ("opc", 1),
        ("b", 4), ("ts1p", 1), ("tsd1", 4),
    ]


_RS2_SPEC = [("c", 4), ("ts2p", 1), ("tsd2", 4)]
_WRITE_SPEC = [("a", 4), ("a_prev_lo", 1), ("a_prev_hi", 1),
               ("ts3p", 1), ("tsd3", 4), ("nz", 1), ("inv_a", 1)]


class _ExecBase(Component):
    """Shared framework for execution families.

    Subclasses set FLAGS (opcode tuple), EXTRA (schema extension),
    HAS_RS2 / HAS_WRITE, and implement `body(ctx, c, E)` returning the
    exec-emit (mult, next_pc value).  E is a dict of shared Felts.
    """

    FLAGS: tuple = ()
    EXTRA: list = []
    HAS_RS2 = True
    HAS_WRITE = True

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if not cls.FLAGS:
            return
        spec = _common_spec(len(cls.FLAGS))
        if cls.HAS_RS2:
            spec += _RS2_SPEC
        if cls.HAS_WRITE:
            spec += _WRITE_SPEC
        spec += cls.EXTRA
        cls.SCHEMA = Schema(spec)
        cls.n_main = cls.SCHEMA.n_cols

    def params(self):
        return {}

    # -- family hooks ---------------------------------------------------
    def uses_rs2(self, F, E):
        """Multiplicity of the rs2 read slot (default: every real row)."""
        return E["real"]

    def writes(self, F, E):
        """Multiplicity of the rd write slot (default: every real row)."""
        return E["real"]

    def reg3(self, c, F, E):
        return c("opa")

    def body(self, ctx, c, E):
        """Family constraints; returns (emit_mult, next_pc value)."""
        raise NotImplementedError

    # -- the shared evaluate ---------------------------------------------
    def evaluate(self, ctx):
        c = Cols(ctx, self.SCHEMA)
        F = {op: c("f", i) for i, op in enumerate(self.FLAGS)}
        pad = c("pad")
        real = 1 - pad
        clk = c("clk")
        ctx.constraint(pad * (pad - 1))
        for op in self.FLAGS:
            ctx.constraint(F[op] * (F[op] - 1))
        ctx.constraint(_sum([F[op] for op in self.FLAGS]) - real)

        pc_lo, pc_hi = c.lo("pc"), c.hi("pc")
        pcW = pc_lo + pc_hi * (1 << 16)
        imm_lo, imm_hi = c.lo("imm"), c.hi("imm")
        b_lo, b_hi = c.lo("b"), c.hi("b")
        E = {"F": F, "real": real, "pad": pad, "clk": clk,
             "pcW": pcW, "pc_lo": pc_lo, "pc_hi": pc_hi,
             "imm_lo": imm_lo, "imm_hi": imm_hi,
             "immW": imm_lo + imm_hi * (1 << 16),
             "b_lo": b_lo, "b_hi": b_hi}
        if self.HAS_RS2:
            E["c_lo"], E["c_hi"] = c.lo("c"), c.hi("c")
        if self.HAS_WRITE:
            E["a_lo"], E["a_hi"] = c.lo("a"), c.hi("a")

        # ---- family body first: constraints + the exec-emit value.
        # Entry order (degree-aware pairing; see module docstring):
        #   [pre_fractions...] prog, exec-, exec+, reg1-, reg1+,
        #   [rs2-, rs2+], [reg3-, reg3+], family fractions, ranges
        emit_mult, npcW = self.body(ctx, c, E)
        u2 = self.uses_rs2(F, E) if self.HAS_RS2 else 0
        wr = self.writes(F, E) if self.HAS_WRITE else 0

        # fetch
        opid = _sum([F[op] * int(op) for op in self.FLAGS])
        ctx.add_fraction(real, "prog",
                         [pcW, opid, c("opa"), c("opb"), c("opc"),
                          imm_lo, imm_hi])
        # execution chain
        ctx.add_fraction(-real, "exec", [clk, pcW])
        ctx.add_fraction(emit_mult, "exec", [clk + 1, npcW])
        # register slot 1 (rs1 read, ts = 3clk+1)
        ts1 = 3 * clk + 1
        ctx.add_fraction(-real, "reg", [c("opb"), b_lo, b_hi, c("ts1p")])
        ctx.add_fraction(real, "reg", [c("opb"), b_lo, b_hi, ts1])
        tsd1 = c.word("tsd1")
        ctx.constraint(real * (ts1 - c("ts1p") - 1 - tsd1))
        # register slot 2 (rs2 read, ts = 3clk+2)
        if self.HAS_RS2:
            ts2 = 3 * clk + 2
            ctx.add_fraction(-u2, "reg", [c("opc"), E["c_lo"], E["c_hi"],
                                          c("ts2p")])
            ctx.add_fraction(u2, "reg", [c("opc"), E["c_lo"], E["c_hi"],
                                         ts2])
            tsd2 = c.word("tsd2")
            ctx.constraint(u2 * (ts2 - c("ts2p") - 1 - tsd2))
        # register slot 3 (rd write, ts = 3clk+3; x0 writes pinned to 0)
        if self.HAS_WRITE:
            r3 = self.reg3(c, F, E)
            nz = c("nz")
            ctx.constraint(nz * (nz - 1))
            ctx.constraint(r3 * c("inv_a") - nz)
            ctx.constraint(r3 * (1 - nz))
            ts3 = 3 * clk + 3
            ctx.add_fraction(-wr, "reg", [r3, c("a_prev_lo"),
                                          c("a_prev_hi"), c("ts3p")])
            ctx.add_fraction(wr, "reg",
                             [r3, E["a_lo"] * nz, E["a_hi"] * nz, ts3])
            tsd3 = c.word("tsd3")
            ctx.constraint(wr * (ts3 - c("ts3p") - 1 - tsd3))

        self.extra_fractions(ctx, c, E)

        # ---- byte range checks (unconditional, pads hit table row 0)
        r256 = [("pc", 3), ("imm", 4), ("b", 4), ("tsd1", 3)]
        r64 = [("pc", 3), ("tsd1", 3)]
        if self.HAS_RS2:
            r256 += [("c", 4), ("tsd2", 3)]
            r64 += [("tsd2", 3)]
        if self.HAS_WRITE:
            r256 += [("a", 4), ("tsd3", 3)]
            r64 += [("tsd3", 3)]
        for name, k in r256 + self.extra_r256():
            for i in range(k):
                ctx.add_fraction(1, "r256", [c(name, i)])
        for name, _ in r64 + self.extra_r64():
            ctx.add_fraction(1, "r64", [c(name, 3)])

    def extra_fractions(self, ctx, c, E):
        """Family lookups placed after the register block."""

    def extra_r256(self):
        return []

    def extra_r64(self):
        return []

    # -- shared fill ------------------------------------------------------
    def fill(self, s, n: int, N: int, view, ctx: dict) -> tuple:
        """s: per-family filtered step arrays (length n); N = 2^log.
        Returns (fill dict, emits dict of table row-index arrays)."""
        f = self.SCHEMA.alloc(N)
        emits = {}
        opc_arr = s["opcode"]

        def sel(ops):
            if isinstance(ops, Opcode):
                return opc_arr == int(ops)
            m = np.zeros(n, bool)
            for o in ops:
                m |= opc_arr == int(o)
            return m

        for i, op in enumerate(self.FLAGS):
            if f["f"].ndim == 1:
                f["f"][:n] = sel(op)
            else:
                f["f"][:n, i] = sel(op)
        f["pad"][n:] = 1
        f["clk"][:n] = s["clk"]
        _bytes4(f, "pc", s["pc"], slice(0, n))
        _bytes4(f, "imm", s["imm"], slice(0, n))
        f["opa"][:n] = s["rd"]
        f["opb"][:n] = s["rs1"]
        b_val = s["b_val"].astype(np.uint64)
        _bytes4(f, "b", b_val, slice(0, n))
        clk = s["clk"].astype(np.uint64)
        ts1p = s["ts1_prev"].astype(np.uint64)
        f["ts1p"][:n] = ts1p
        _limbs(f, "tsd1", 3 * clk + 1 - ts1p - 1, slice(0, n))
        self.fill_body(f, s, n, sel, view, ctx, emits)
        # op_c matches the program table: rs2 on rows that read it
        # (R/S/B-type and ecall), 0 otherwise (decode_program_table)
        u2_mask = np.asarray(ctx.get("uses_rs2", np.zeros(n, bool)),
                             bool)
        f["opc"][:n] = np.where(u2_mask, s["rs2"], 0)
        # shared blocks that depend on family multiplicities
        if self.HAS_RS2:
            u2 = np.asarray(ctx["uses_rs2"], bool)
            c_arr = np.asarray(ctx["c_val"], np.uint64)
            _bytes4(f, "c", c_arr, slice(0, n))
            ts2p = np.where(u2, s["ts2_prev"].astype(np.uint64), 0)
            f["ts2p"][:n] = ts2p
            _limbs(f, "tsd2", np.where(u2, 3 * clk + 2 - ts2p - 1, 0),
                   slice(0, n))
        if self.HAS_WRITE:
            wr = np.asarray(ctx["writes"], bool)
            a_arr = np.where(wr, s["a_val"].astype(np.uint64), 0)
            _bytes4(f, "a", a_arr, slice(0, n))
            a_prev = np.where(wr, s["a_prev"].astype(np.uint64), 0)
            f["a_prev_lo"][:n] = a_prev & 0xFFFF
            f["a_prev_hi"][:n] = a_prev >> 16
            ts3p = np.where(wr, s["ts3_prev"].astype(np.uint64), 0)
            f["ts3p"][:n] = ts3p
            _limbs(f, "tsd3", np.where(wr, 3 * clk + 3 - ts3p - 1, 0),
                   slice(0, n))
            r3 = ctx.get("reg3", s["rd"]).astype(np.uint64)
            if "reg3" in self.SCHEMA.index:
                f["reg3"][:n] = r3
            f["nz"][:n] = r3 != 0
            f["inv_a"][:n] = _inv_or_zero(r3)

        # unconditional range emits over the FULL padded column arrays
        def col(name, i=0):
            a = f[name]
            return (a[:, i] if a.ndim == 2 else a).astype(np.int64)

        def emit(rel, idx):
            emits.setdefault(rel, []).append(np.asarray(idx, np.int64))

        r256 = [("pc", 3), ("imm", 4), ("b", 4), ("tsd1", 3)]
        r64 = [("pc", 3), ("tsd1", 3)]
        if self.HAS_RS2:
            r256 += [("c", 4), ("tsd2", 3)]
            r64 += [("tsd2", 3)]
        if self.HAS_WRITE:
            r256 += [("a", 4), ("tsd3", 3)]
            r64 += [("tsd3", 3)]
        for name, k in r256 + self.extra_r256():
            for i in range(k):
                emit("r256", col(name, i))
        for name, _ in r64 + self.extra_r64():
            emit("r64", col(name, 3))
        emits = {k: np.concatenate(v) for k, v in emits.items()}
        return f, emits

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        """Family-specific fill; must set ctx['uses_rs2'/'writes'/
        'c_val'] as applicable and may append masked emits."""
        raise NotImplementedError


def _emit(emits, rel, idx):
    emits.setdefault(rel, []).append(np.asarray(idx, np.int64))


# ---------------------------------------------------------------------------
# ALU: ADD / ADDI / SUB / LUI / AUIPC
# ---------------------------------------------------------------------------

class ExAlu(_ExecBase):
    """Add/sub/upper-immediate ALU (reference AddChip/SubChip/LuiChip/
    AuipcChip, `nexus-zkvm/prover/src/chips/instructions/i/`)."""
    name = "ex_alu"
    FLAGS = (Opcode.ADD, Opcode.ADDI, Opcode.SUB, Opcode.LUI,
             Opcode.AUIPC)
    EXTRA = [("carry", 2)]

    def uses_rs2(self, F, E):
        return F[Opcode.ADD] + F[Opcode.SUB]

    def body(self, ctx, c, E):
        F = E["F"]
        ca1, ca2 = c("carry", 0), c("carry", 1)
        ctx.constraint(ca1 * (ca1 - 1))
        ctx.constraint(ca2 * (ca2 - 1))
        # ADDI consumes the immediate through c
        for i in range(4):
            ctx.constraint(F[Opcode.ADDI] * (c("c", i) - c("imm", i)))
        b_lo, b_hi = E["b_lo"], E["b_hi"]
        c_lo, c_hi = E["c_lo"], E["c_hi"]
        a_lo, a_hi = E["a_lo"], E["a_hi"]
        addc = F[Opcode.ADD] + F[Opcode.ADDI]
        ctx.constraint(addc * (b_lo + c_lo - a_lo - ca1 * (1 << 16)))
        ctx.constraint(addc * (b_hi + c_hi + ca1 - a_hi
                               - ca2 * (1 << 16)))
        ctx.constraint(F[Opcode.SUB] * (b_lo - c_lo + ca1 * (1 << 16)
                                        - a_lo))
        ctx.constraint(F[Opcode.SUB] * (b_hi - c_hi - ca1
                                        + ca2 * (1 << 16) - a_hi))
        for i in range(4):
            ctx.constraint(F[Opcode.LUI] * (c("a", i) - c("imm", i)))
        ctx.constraint(F[Opcode.AUIPC] * (E["pc_lo"] + E["imm_lo"]
                                          - a_lo - ca1 * (1 << 16)))
        ctx.constraint(F[Opcode.AUIPC] * (E["pc_hi"] + E["imm_hi"] + ca1
                                          - a_hi - ca2 * (1 << 16)))
        return E["real"], E["pcW"] + 4

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        imm = s["imm"].astype(np.uint64)
        u2 = sel({Opcode.ADD, Opcode.SUB})
        c_arr = np.where(u2, s["c_val"].astype(np.uint64),
                         np.where(sel(Opcode.ADDI), imm, 0))
        ctx["uses_rs2"] = u2
        ctx["writes"] = np.ones(n, bool)
        ctx["c_val"] = c_arr
        b = s["b_val"].astype(np.uint64)
        pc = s["pc"].astype(np.uint64)
        b_lo, c_lo = b & 0xFFFF, c_arr & 0xFFFF
        b_hi, c_hi = b >> 16, c_arr >> 16
        pc_lo, pc_hi = pc & 0xFFFF, pc >> 16
        imm_lo, imm_hi = imm & 0xFFFF, imm >> 16
        ca1 = np.zeros(n, np.uint64)
        ca2 = np.zeros(n, np.uint64)
        m = sel({Opcode.ADD, Opcode.ADDI})
        ca1[m] = (b_lo + c_lo)[m] >> 16
        ca2[m] = (b_hi + c_hi + ca1)[m] >> 16
        m = sel(Opcode.SUB)
        ca1[m] = (b_lo < c_lo)[m]
        ca2[m] = ((b_hi - c_hi - ca1) >> 63)[m] & 1
        m = sel(Opcode.AUIPC)
        ca1[m] = (pc_lo + imm_lo)[m] >> 16
        ca2[m] = (pc_hi + imm_hi + ca1)[m] >> 16
        f["carry"][:n, 0] = ca1
        f["carry"][:n, 1] = ca2


# ---------------------------------------------------------------------------
# Bitwise: AND(I) / OR(I) / XOR(I) via nibble tables
# ---------------------------------------------------------------------------

class ExBit(_ExecBase):
    """Bitwise ops via 4-bit lookup tables (reference BitOpChip,
    `nexus-zkvm/prover/src/chips/instructions/i/bit_op.rs`)."""
    name = "ex_bit"
    FLAGS = (Opcode.AND, Opcode.ANDI, Opcode.OR, Opcode.ORI,
             Opcode.XOR, Opcode.XORI)
    EXTRA = [("bh", 4), ("ch", 4), ("ah", 4)]

    def uses_rs2(self, F, E):
        return F[Opcode.AND] + F[Opcode.OR] + F[Opcode.XOR]

    def body(self, ctx, c, E):
        F = E["F"]
        for op in (Opcode.ANDI, Opcode.ORI, Opcode.XORI):
            for i in range(4):
                ctx.constraint(F[op] * (c("c", i) - c("imm", i)))
        return E["real"], E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        F = E["F"]
        and_cls = F[Opcode.AND] + F[Opcode.ANDI]
        or_cls = F[Opcode.OR] + F[Opcode.ORI]
        xor_cls = F[Opcode.XOR] + F[Opcode.XORI]
        for i in range(4):
            bh, ch, ah = c("bh", i), c("ch", i), c("ah", i)
            bl = c("b", i) - 16 * bh
            cl = c("c", i) - 16 * ch
            al = c("a", i) - 16 * ah
            for (x, y, z) in ((bh, ch, ah), (bl, cl, al)):
                ctx.add_fraction(and_cls, "and4", [x, y, z])
                ctx.add_fraction(or_cls, "and4", [x, y, x + y - z])
                ctx.add_fraction(xor_cls, "xor4", [x, y, z])

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        from ..machine.tables import bitop_row_index
        imm = s["imm"].astype(np.uint64)
        u2 = sel({Opcode.AND, Opcode.OR, Opcode.XOR})
        c_arr = np.where(u2, s["c_val"].astype(np.uint64), imm)
        ctx["uses_rs2"] = u2
        ctx["writes"] = np.ones(n, bool)
        ctx["c_val"] = c_arr
        b = s["b_val"].astype(np.uint64)
        a = s["a_val"].astype(np.uint64)
        and_or = sel({Opcode.AND, Opcode.ANDI, Opcode.OR, Opcode.ORI})
        xor_on = sel({Opcode.XOR, Opcode.XORI})
        for i in range(4):
            bb = (b >> (8 * i)) & 0xFF
            cb = (c_arr >> (8 * i)) & 0xFF
            ab = (a >> (8 * i)) & 0xFF
            f["bh"][:n, i] = bb >> 4
            f["ch"][:n, i] = cb >> 4
            f["ah"][:n, i] = ab >> 4
            for part in (lambda v: v >> 4, lambda v: v & 0xF):
                _emit(emits, "and4", bitop_row_index(part(bb)[and_or],
                                                     part(cb)[and_or]))
                _emit(emits, "xor4", bitop_row_index(part(bb)[xor_on],
                                                     part(cb)[xor_on]))


# ---------------------------------------------------------------------------
# Shifts: SLL(I) / SRL(I) / SRA(I) via byte-shift tables
# ---------------------------------------------------------------------------

class ExShift(_ExecBase):
    """Shifts via SHL8/SHR8 byte tables (reference Sll/Srl/SraChip,
    `nexus-zkvm/prover/src/chips/instructions/i/sll.rs`)."""
    name = "ex_shift"
    FLAGS = (Opcode.SLL, Opcode.SLLI, Opcode.SRL, Opcode.SRLI,
             Opcode.SRA, Opcode.SRAI)
    EXTRA = [("c0q", 1), ("sh_r", 1), ("q", 4),
             ("sh_x", 4), ("sh_y", 4), ("sh_rem", 4),
             ("sh_ph", 1), ("sh_p", 1), ("sgn_b", 1), ("b3l7", 1)]

    def uses_rs2(self, F, E):
        return F[Opcode.SLL] + F[Opcode.SRL] + F[Opcode.SRA]

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        for op in (Opcode.SLLI, Opcode.SRLI, Opcode.SRAI):
            for i in range(4):
                ctx.constraint(F[op] * (c("c", i) - c("imm", i)))
        qs = [c("q", i) for i in range(4)]
        for q in qs:
            ctx.constraint(q * (q - 1))
        ctx.constraint(real * (_sum(qs) - 1))
        ctx.constraint(real * (
            c("c", 0) - 32 * c("c0q")
            - 8 * (qs[1] + 2 * qs[2] + 3 * qs[3]) - c("sh_r")))
        sra_cls = F[Opcode.SRA] + F[Opcode.SRAI]
        sgn = c("sgn_b")
        ctx.constraint(sgn * (sgn - 1))
        ctx.constraint(sra_cls * (c("b", 3) - 128 * sgn - c("b3l7")))
        sll_cls = F[Opcode.SLL] + F[Opcode.SLLI]
        srl_cls = F[Opcode.SRL] + F[Opcode.SRLI]
        fill = 256 - c("sh_p") - 256 * c("sh_ph")
        for j in range(4):
            tl = [c("sh_y", j - k) + (c("sh_x", j - k - 1) if j - k >= 1
                                      else 0) if j - k >= 0 else 0
                  for k in range(4)]
            sll_a = _sum([qs[k] * tl[k] for k in range(4)
                          if not isinstance(tl[k], int)])
            ctx.constraint(sll_cls * (c("a", j) - sll_a))
            tr = [(c("sh_x", j + k) + (c("sh_y", j + k + 1)
                                       if j + k + 1 <= 3 else 0))
                  if j + k <= 3 else None for k in range(4)]
            srl_a = _sum([qs[k] * tr[k] for k in range(4)
                          if tr[k] is not None])
            ctx.constraint(srl_cls * (c("a", j) - srl_a))
            sra_terms = []
            for k in range(4):
                if tr[k] is not None:
                    t = tr[k] + (sgn * fill if j + k == 3 else 0)
                    sra_terms.append(qs[k] * t)
                else:
                    sra_terms.append(qs[k] * (sgn * 255))
            ctx.constraint(sra_cls * (c("a", j) - _sum(sra_terms)))
        return real, E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        F = E["F"]
        sll_cls = F[Opcode.SLL] + F[Opcode.SLLI]
        srl_cls = F[Opcode.SRL] + F[Opcode.SRLI]
        sra_cls = F[Opcode.SRA] + F[Opcode.SRAI]
        shr_cls = srl_cls + sra_cls
        ctx.add_fraction(E["real"], "r8", [c("c0q")])
        for i in range(4):
            ctx.add_fraction(sll_cls, "shl8",
                             [c("b", i), c("sh_r"), c("sh_x", i),
                              c("sh_y", i)])
            ctx.add_fraction(shr_cls, "shr8",
                             [c("b", i), c("sh_r"), c("sh_x", i),
                              c("sh_rem", i)])
            ctx.add_fraction(shr_cls, "shl8",
                             [c("sh_rem", i), 8 - c("sh_r"), 0,
                              c("sh_y", i)])
        ctx.add_fraction(sra_cls, "shl8",
                         [1, 8 - c("sh_r"), c("sh_ph"), c("sh_p")])
        ctx.add_fraction(1, "r128", [c("b3l7")])

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        imm = s["imm"].astype(np.uint64)
        u2 = sel({Opcode.SLL, Opcode.SRL, Opcode.SRA})
        c_arr = np.where(u2, s["c_val"].astype(np.uint64), imm)
        ctx["uses_rs2"] = u2
        ctx["writes"] = np.ones(n, bool)
        ctx["c_val"] = c_arr
        b = s["b_val"].astype(np.uint64)
        sll_on = sel({Opcode.SLL, Opcode.SLLI})
        shr_on = sel({Opcode.SRL, Opcode.SRLI, Opcode.SRA, Opcode.SRAI})
        sra_on = sel({Opcode.SRA, Opcode.SRAI})
        c0 = c_arr & 0xFF
        f["c0q"][:n] = c0 >> 5
        sh5 = c0 & 31
        q_idx = sh5 >> 3
        r = sh5 & 7
        f["sh_r"][:n] = r
        for k in range(4):
            f["q"][:n, k] = q_idx == k
        for i in range(4):
            bb = (b >> (8 * i)) & 0xFF
            x = np.zeros(n, np.uint64)
            y = np.zeros(n, np.uint64)
            rem = np.zeros(n, np.uint64)
            prod = bb << r
            x[sll_on] = (prod >> 8)[sll_on]
            y[sll_on] = (prod & 0xFF)[sll_on]
            x[shr_on] = (bb >> r)[shr_on]
            rem[shr_on] = (bb - ((bb >> r) << r))[shr_on]
            y[shr_on] = ((rem << (8 - r)) & 0xFF)[shr_on]
            f["sh_x"][:n, i] = x
            f["sh_y"][:n, i] = y
            f["sh_rem"][:n, i] = rem
            _emit(emits, "shl8", bb[sll_on] * 9 + r[sll_on])
            _emit(emits, "shl8", rem[shr_on] * 9 + (8 - r[shr_on]))
            _emit(emits, "shr8", bb[shr_on] * 8 + r[shr_on])
        f["sh_ph"][:n] = np.where(sra_on,
                                  (np.uint64(1) << (8 - r)) >> 8, 0)
        f["sh_p"][:n] = np.where(sra_on,
                                 (np.uint64(1) << (8 - r)) & 0xFF, 0)
        b3 = (b >> 24) & 0xFF
        f["sgn_b"][:n] = np.where(sra_on, b3 >> 7, 0)
        f["b3l7"][:n] = np.where(sra_on, b3 & 0x7F, 0)
        _emit(emits, "shl8", np.full(int(sra_on.sum()), 1, np.int64) * 9
              + (8 - r[sra_on]))
        _emit(emits, "r8", f["c0q"][:n].astype(np.int64))
        _emit(emits, "r128", f["b3l7"].astype(np.int64))


# ---------------------------------------------------------------------------
# Compares: SLT(I) / SLTU(I)
# ---------------------------------------------------------------------------

class ExCmp(_ExecBase):
    """Set-less-than (reference SltChip/SltuChip)."""
    name = "ex_cmp"
    FLAGS = (Opcode.SLT, Opcode.SLTI, Opcode.SLTU, Opcode.SLTIU)
    EXTRA = [("sgn_b", 1), ("sgn_c", 1), ("b3l7", 1), ("c3l7", 1),
             ("br1", 1), ("br2", 1), ("h", 4)]

    def uses_rs2(self, F, E):
        return F[Opcode.SLT] + F[Opcode.SLTU]

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        for op in (Opcode.SLTI, Opcode.SLTIU):
            for i in range(4):
                ctx.constraint(F[op] * (c("c", i) - c("imm", i)))
        br1, br2 = c("br1"), c("br2")
        for v in (br1, br2, c("sgn_b"), c("sgn_c")):
            ctx.constraint(v * (v - 1))
        h_lo, h_hi = c.lo("h"), c.hi("h")
        ctx.constraint(real * (E["b_lo"] - E["c_lo"] + br1 * (1 << 16)
                               - h_lo))
        ctx.constraint(real * (E["b_hi"] - E["c_hi"] - br1
                               + br2 * (1 << 16) - h_hi))
        ctx.constraint(real * (c("b", 3) - 128 * c("sgn_b") - c("b3l7")))
        ctx.constraint(real * (c("c", 3) - 128 * c("sgn_c") - c("c3l7")))
        sgn_xor = c("sgn_b") + c("sgn_c") - 2 * c("sgn_b") * c("sgn_c")
        lt_s = br2 + sgn_xor - 2 * br2 * sgn_xor     # deg 3
        sltu_cls = F[Opcode.SLTU] + F[Opcode.SLTIU]
        slt_cls = F[Opcode.SLT] + F[Opcode.SLTI]
        ctx.constraint(sltu_cls * (c("a", 0) - br2))
        ctx.constraint(slt_cls * (c("a", 0) - lt_s))
        for i in range(1, 4):
            ctx.constraint(real * c("a", i))
        return real, E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        ctx.add_fraction(1, "r128", [c("b3l7")])
        ctx.add_fraction(1, "r128", [c("c3l7")])

    def extra_r256(self):
        return [("h", 4)]

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        imm = s["imm"].astype(np.uint64)
        u2 = sel({Opcode.SLT, Opcode.SLTU})
        c_arr = np.where(u2, s["c_val"].astype(np.uint64), imm)
        ctx["uses_rs2"] = u2
        ctx["writes"] = np.ones(n, bool)
        ctx["c_val"] = c_arr
        b = s["b_val"].astype(np.uint64)
        _cmp_fill(f, n, b, c_arr, np.ones(n, bool))
        _emit(emits, "r128", f["b3l7"].astype(np.int64))
        _emit(emits, "r128", f["c3l7"].astype(np.int64))


def _cmp_fill(f, n, b, c_arr, on):
    """Shared borrow-compare fill: br1/br2/h (+sgn columns)."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    c_lo, c_hi = c_arr & 0xFFFF, c_arr >> 16
    br1 = np.zeros(n, np.uint64)
    br2 = np.zeros(n, np.uint64)
    br1[on] = (b_lo < c_lo)[on]
    h_lo = np.where(on, (b_lo - c_lo + (br1 << 16)) & 0xFFFF, 0)
    br2[on] = ((b_hi - c_hi - br1) >> 63)[on] & 1
    h_hi = np.where(on, (b_hi - c_hi - br1 + (br2 << 16)) & 0xFFFF, 0)
    f["br1"][:n] = br1
    f["br2"][:n] = br2
    f["h"][:n, 0] = h_lo & 0xFF
    f["h"][:n, 1] = h_lo >> 8
    f["h"][:n, 2] = h_hi & 0xFF
    f["h"][:n, 3] = h_hi >> 8
    b3 = (b >> 24) & 0xFF
    c3 = (c_arr >> 24) & 0xFF
    f["sgn_b"][:n] = np.where(on, b3 >> 7, 0)
    f["sgn_c"][:n] = np.where(on, c3 >> 7, 0)
    f["b3l7"][:n] = np.where(on, b3 & 0x7F, 0)
    f["c3l7"][:n] = np.where(on, c3 & 0x7F, 0)
    return h_lo, h_hi


# ---------------------------------------------------------------------------
# Branches: BEQ / BNE / BLT / BGE / BLTU / BGEU
# ---------------------------------------------------------------------------

class ExBranch(_ExecBase):
    """Conditional branches; the taken bit `t` is committed and the
    branch target is emitted arithmetically (no next-pc columns)."""
    name = "ex_branch"
    FLAGS = (Opcode.BEQ, Opcode.BNE, Opcode.BLT, Opcode.BGE,
             Opcode.BLTU, Opcode.BGEU)
    HAS_WRITE = False
    EXTRA = [("sgn_b", 1), ("sgn_c", 1), ("b3l7", 1), ("c3l7", 1),
             ("br1", 1), ("br2", 1), ("h", 4),
             ("e_lo", 1), ("i_lo", 1), ("e_hi", 1), ("i_hi", 1),
             ("t", 1), ("im_s", 1), ("im_l7", 1)]

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        br1, br2, t = c("br1"), c("br2"), c("t")
        for v in (br1, br2, t, c("sgn_b"), c("sgn_c"), c("e_lo"),
                  c("e_hi"), c("im_s")):
            ctx.constraint(v * (v - 1))
        h_lo, h_hi = c.lo("h"), c.hi("h")
        ctx.constraint(real * (E["b_lo"] - E["c_lo"] + br1 * (1 << 16)
                               - h_lo))
        ctx.constraint(real * (E["b_hi"] - E["c_hi"] - br1
                               + br2 * (1 << 16) - h_hi))
        # equality flags via the inverse trick (global: pads have h=0,
        # forcing e=1 there — harmless, everything downstream is gated)
        ctx.constraint(c("e_lo") * h_lo)
        ctx.constraint(h_lo * c("i_lo") - (1 - c("e_lo")))
        ctx.constraint(c("e_hi") * h_hi)
        ctx.constraint(h_hi * c("i_hi") - (1 - c("e_hi")))
        ctx.constraint(real * (c("b", 3) - 128 * c("sgn_b") - c("b3l7")))
        ctx.constraint(real * (c("c", 3) - 128 * c("sgn_c") - c("c3l7")))
        sgn_xor = c("sgn_b") + c("sgn_c") - 2 * c("sgn_b") * c("sgn_c")
        lt_s = br2 + sgn_xor - 2 * br2 * sgn_xor
        eq = c("e_lo") * c("e_hi")
        taken = F[Opcode.BEQ] * eq + F[Opcode.BNE] * (1 - eq) \
            + F[Opcode.BLT] * lt_s + F[Opcode.BGE] * (1 - lt_s) \
            + F[Opcode.BLTU] * br2 + F[Opcode.BGEU] * (1 - br2)
        # t == taken (degree 4: F * lt_s); on pads taken = 0 = t
        ctx.constraint(t - taken)
        # immediate sign decomposition pins the 2^32 wrap of the target
        ctx.constraint(real * (c("imm", 3) - 128 * c("im_s")
                               - c("im_l7")))
        # target = pc + 4 + t*(imm_sext - 4); 2^32 = 2 (mod M31)
        npcW = E["pcW"] + 4 + t * (E["immW"] - 2 * c("im_s") - 4)
        return real, npcW

    def extra_fractions(self, ctx, c, E):
        ctx.add_fraction(1, "r128", [c("b3l7")])
        ctx.add_fraction(1, "r128", [c("c3l7")])
        ctx.add_fraction(1, "r128", [c("im_l7")])

    def extra_r256(self):
        return [("h", 4)]

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        c_arr = s["c_val"].astype(np.uint64)
        ctx["uses_rs2"] = np.ones(n, bool)
        ctx["c_val"] = c_arr
        b = s["b_val"].astype(np.uint64)
        h_lo, h_hi = _cmp_fill(f, n, b, c_arr, np.ones(n, bool))
        N = f["pad"].shape[0]
        e_lo = np.ones(N, np.uint64)
        e_hi = np.ones(N, np.uint64)
        e_lo[:n] = h_lo == 0
        e_hi[:n] = h_hi == 0
        f["e_lo"][:] = e_lo
        f["e_hi"][:] = e_hi
        f["i_lo"][:n] = _inv_or_zero(h_lo)
        f["i_hi"][:n] = _inv_or_zero(h_hi)
        imm = s["imm"].astype(np.uint64)
        imm3 = (imm >> 24) & 0xFF
        f["im_s"][:n] = imm3 >> 7
        f["im_l7"][:n] = imm3 & 0x7F
        eq = (e_lo[:n] * e_hi[:n]).astype(bool)
        br2 = f["br2"][:n].astype(bool)
        sgn_xor = (f["sgn_b"][:n] ^ f["sgn_c"][:n]).astype(bool)
        lt_s = br2 ^ sgn_xor
        t = (sel(Opcode.BEQ) & eq) | (sel(Opcode.BNE) & ~eq) \
            | (sel(Opcode.BLT) & lt_s) | (sel(Opcode.BGE) & ~lt_s) \
            | (sel(Opcode.BLTU) & br2) | (sel(Opcode.BGEU) & ~br2)
        f["t"][:n] = t
        for name in ("b3l7", "c3l7", "im_l7"):
            _emit(emits, "r128", f[name].astype(np.int64))


# ---------------------------------------------------------------------------
# Jumps: JAL / JALR
# ---------------------------------------------------------------------------

class ExJump(_ExecBase):
    """Jumps with link write a = pc + 4 (reference JalChip/JalrChip)."""
    name = "ex_jump"
    FLAGS = (Opcode.JAL, Opcode.JALR)
    HAS_RS2 = False
    EXTRA = [("carry", 2), ("c32", 1), ("lsb", 1),
             ("im_s", 1), ("im_l7", 1)]

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        ca1, ca2 = c("carry", 0), c("carry", 1)
        for v in (ca1, ca2, c("c32"), c("lsb"), c("im_s")):
            ctx.constraint(v * (v - 1))
        # link value: a = pc + 4
        ctx.constraint(real * (E["pc_lo"] + 4 - E["a_lo"]
                               - ca1 * (1 << 16)))
        ctx.constraint(real * (E["pc_hi"] + ca1 - E["a_hi"]
                               - ca2 * (1 << 16)))
        ctx.constraint(real * (c("imm", 3) - 128 * c("im_s")
                               - c("im_l7")))
        ctx.constraint(F[Opcode.JAL] * c("c32"))
        ctx.constraint(F[Opcode.JAL] * c("lsb"))
        jr = F[Opcode.JALR]
        # base = pc (JAL) or b (JALR); target = base + imm_sext, with
        # the JALR extra 2^32 carry committed (c32) and bit 0 cleared.
        # An adversarial c32 flip moves the emitted value by +-2 (mod
        # M31) — never another word-aligned pc.
        base_lo = E["pc_lo"] + jr * (E["b_lo"] - E["pc_lo"])
        base_hi = E["pc_hi"] + jr * (E["b_hi"] - E["pc_hi"])
        npcW = base_lo + base_hi * (1 << 16) + E["immW"] \
            - 2 * c("im_s") - 2 * c("c32") - c("lsb")
        return real, npcW

    def extra_fractions(self, ctx, c, E):
        ctx.add_fraction(1, "r128", [c("im_l7")])

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        ctx["writes"] = np.ones(n, bool)
        pc = s["pc"].astype(np.uint64)
        pc_lo = pc & 0xFFFF
        ca1 = (pc_lo + 4) >> 16
        f["carry"][:n, 0] = ca1
        f["carry"][:n, 1] = 0
        imm = s["imm"].astype(np.uint64)
        imm3 = (imm >> 24) & 0xFF
        f["im_s"][:n] = imm3 >> 7
        f["im_l7"][:n] = imm3 & 0x7F
        jr = sel(Opcode.JALR)
        b = s["b_val"].astype(np.uint64)
        tgt_sum = np.where(jr, b + imm, 0)
        # c32: the extra 2^32 wrap beyond the sign wrap (im_s)
        c32 = np.where(jr, (tgt_sum >> 32) - (imm3 >> 7), 0)
        assert np.all(c32 <= 1), "jalr target below 0 is unprovable"
        f["c32"][:n] = c32
        f["lsb"][:n] = np.where(jr, tgt_sum & 1, 0)
        _emit(emits, "r128", f["im_l7"].astype(np.int64))


# ---------------------------------------------------------------------------
# Loads: LB / LH / LW / LBU / LHU
# ---------------------------------------------------------------------------

class ExLoad(_ExecBase):
    """Memory loads: byte-lane mux + sign extension + read-region proof
    (reference LoadStoreChip,
    `nexus-zkvm/prover/src/chips/instructions/i/load_store.rs:64`)."""
    name = "ex_load"
    FLAGS = (Opcode.LB, Opcode.LH, Opcode.LW, Opcode.LBU, Opcode.LHU)
    HAS_RS2 = False
    EXTRA = [("maddr", 4), ("carry", 2), ("mq", 1), ("mofs", 1),
             ("l", 4), ("wp", 4), ("mtsp", 1), ("mtsd", 4),
             ("ld_s", 1), ("ld_l7", 1), ("srd", 4), ("ls_sel", 1)]

    def __init__(self, exit_addr: int = 0, heap_start: int = 0):
        self.exit_addr = int(exit_addr)
        self.heap_start = int(heap_start)

    def params(self):
        return {"exit_addr": self.exit_addr,
                "heap_start": self.heap_start}

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        clk = E["clk"]
        ca1, ca2 = c("carry", 0), c("carry", 1)
        for v in (ca1, ca2, c("ls_sel"), c("ld_s")):
            ctx.constraint(v * (v - 1))
        maddr_lo, maddr_hi = c.lo("maddr"), c.hi("maddr")
        maddrW = maddr_lo + maddr_hi * (1 << 16)
        ctx.constraint(real * (E["b_lo"] + E["imm_lo"] - maddr_lo
                               - ca1 * (1 << 16)))
        ctx.constraint(real * (E["b_hi"] + E["imm_hi"] + ca1 - maddr_hi
                               - ca2 * (1 << 16)))
        mem_b = F[Opcode.LB] + F[Opcode.LBU]
        mem_h = F[Opcode.LH] + F[Opcode.LHU]
        lf = [c("l", i) for i in range(4)]
        for v in lf:
            ctx.constraint(v * (v - 1))
        mofs = c("mofs")
        ctx.constraint(real * (c("maddr", 0) - 4 * c("mq") - mofs))
        ctx.constraint(mem_b * (_sum(lf) - 1))
        ctx.constraint(mem_b * (mofs - lf[1] - 2 * lf[2] - 3 * lf[3]))
        ctx.constraint(mem_h * (lf[0] + lf[2] - 1))
        ctx.constraint(mem_h * (lf[1] + lf[3]))
        ctx.constraint(mem_h * (mofs - 2 * lf[2]))
        ctx.constraint(F[Opcode.LW] * mofs)
        # value extraction from the previous word
        src_b = _sum([lf[i] * c("wp", i) for i in range(4)])
        src_h_lo = lf[0] * c("wp", 0) + lf[2] * c("wp", 2)
        src_h_hi = lf[0] * c("wp", 1) + lf[2] * c("wp", 3)
        sign_src = F[Opcode.LB] * src_b + F[Opcode.LH] * src_h_hi
        ctx.constraint((F[Opcode.LB] + F[Opcode.LH])
                       * (sign_src - 128 * c("ld_s") - c("ld_l7")))
        lb_, lbu = F[Opcode.LB], F[Opcode.LBU]
        lh_, lhu = F[Opcode.LH], F[Opcode.LHU]
        ctx.constraint((lb_ + lbu) * (c("a", 0) - src_b))
        ctx.constraint((lh_ + lhu) * (c("a", 0) - src_h_lo))
        ctx.constraint((lh_ + lhu) * (c("a", 1) - src_h_hi))
        ctx.constraint(lb_ * (c("a", 1) - 255 * c("ld_s")))
        ctx.constraint((lb_ + lh_) * (c("a", 2) - 255 * c("ld_s")))
        ctx.constraint((lb_ + lh_) * (c("a", 3) - 255 * c("ld_s")))
        ctx.constraint(lbu * c("a", 1))
        ctx.constraint((lbu + lhu) * c("a", 2))
        ctx.constraint((lbu + lhu) * c("a", 3))
        for i in range(4):
            ctx.constraint(F[Opcode.LW] * (c("a", i) - c("wp", i)))
        # read-region proof: avoid the write-only [exit_code, heap)
        srd = c.word("srd")
        sel_ = c("ls_sel")
        ctx.constraint(real * (
            sel_ * (ctx.param("exit_addr") - 1 - maddrW)
            + (1 - sel_) * (maddrW - ctx.param("heap_start")) - srd))
        mtsd = c.word("mtsd")
        ctx.constraint(real * (clk - c("mtsp") - 1 - mtsd))
        self._maddrW = maddrW
        self._mofs = mofs
        return real, E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        real, clk = E["real"], E["clk"]
        alignedW = self._maddrW - self._mofs
        wp_lo, wp_hi = c.lo("wp"), c.hi("wp")
        ctx.add_fraction(-real, "mem", [alignedW, wp_lo, wp_hi,
                                        c("mtsp")])
        ctx.add_fraction(real, "mem", [alignedW, wp_lo, wp_hi, clk])
        ctx.add_fraction(1, "r64", [c("mq")])
        ctx.add_fraction(1, "r128", [c("ld_l7")])

    def extra_r256(self):
        return [("maddr", 3), ("wp", 4), ("mtsd", 3), ("srd", 3)]

    def extra_r64(self):
        return [("maddr", 3), ("mtsd", 3), ("srd", 3)]

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        ctx["writes"] = np.ones(n, bool)
        _mem_addr_fill(f, s, n, sel, emits)
        wp = s["mem_prev_val"].astype(np.uint64)
        _bytes4(f, "wp", wp, slice(0, n))
        clk = s["clk"].astype(np.uint64)
        mtsp = s["mem_prev_ts"].astype(np.uint64)
        f["mtsp"][:n] = mtsp
        _limbs(f, "mtsd", clk - mtsp - 1, slice(0, n))
        raw = s["mem_addr"].astype(np.uint64)
        ofs = raw & 3
        lbh = sel({Opcode.LB, Opcode.LH})
        wp_bytes = [(wp >> (8 * i)) & 0xFF for i in range(4)]
        src_b = np.select([ofs == i for i in range(4)], wp_bytes, 0)
        src_h_hi = np.where(ofs == 2, wp_bytes[3], wp_bytes[1])
        sign_src = np.where(sel(Opcode.LB), src_b,
                            np.where(sel(Opcode.LH), src_h_hi, 0))
        f["ld_s"][:n] = np.where(lbh, sign_src >> 7, 0)
        f["ld_l7"][:n] = np.where(lbh, sign_src & 0x7F, 0)
        lay = view.memory_layout
        below = raw < lay.exit_code
        f["ls_sel"][:n] = below
        srd = np.where(below, lay.exit_code - 1 - raw,
                       raw - lay.heap_start)
        _limbs(f, "srd", srd, slice(0, n))
        _emit(emits, "r64", f["mq"].astype(np.int64))
        _emit(emits, "r128", f["ld_l7"].astype(np.int64))


def _mem_addr_fill(f, s, n, sel, emits):
    """Shared load/store fill: maddr bytes, carries, lane one-hot."""
    b = s["b_val"].astype(np.uint64)
    imm = s["imm"].astype(np.uint64)
    raw = s["mem_addr"].astype(np.uint64)
    _bytes4(f, "maddr", raw, slice(0, n))
    b_lo, imm_lo = b & 0xFFFF, imm & 0xFFFF
    b_hi, imm_hi = b >> 16, imm >> 16
    ca1 = (b_lo + imm_lo) >> 16
    ca2 = ((b_hi + imm_hi + ca1) >> 16) & 1
    f["carry"][:n, 0] = ca1
    f["carry"][:n, 1] = ca2
    m0 = raw & 0xFF
    f["mq"][:n] = m0 >> 2
    ofs = m0 & 3
    f["mofs"][:n] = ofs
    mem_b = sel({Opcode.LB, Opcode.LBU, Opcode.SB})
    mem_h = sel({Opcode.LH, Opcode.LHU, Opcode.SH})
    for i in range(4):
        f["l"][:n, i] = (mem_b & (ofs == i)) \
            | (mem_h & (i in (0, 2)) & (ofs == i))


# ---------------------------------------------------------------------------
# Stores: SB / SH / SW
# ---------------------------------------------------------------------------

class ExStore(_ExecBase):
    """Memory stores: lane-muxed word update + write-region proofs."""
    name = "ex_store"
    FLAGS = (Opcode.SB, Opcode.SH, Opcode.SW)
    HAS_WRITE = False
    EXTRA = [("maddr", 4), ("carry", 2), ("mq", 1), ("mofs", 1),
             ("l", 4), ("wp", 4), ("wn", 4), ("mtsp", 1), ("mtsd", 4),
             ("srd", 4), ("srd2", 4), ("st_sel", 1)]

    def __init__(self, exit_addr: int = 0, static_lo=None,
                 static_hi=None):
        self.exit_addr = int(exit_addr)
        self.static_lo = int(static_lo if static_lo is not None
                             else exit_addr)
        self.static_hi = int(static_hi if static_hi is not None
                             else exit_addr)

    def params(self):
        return {"exit_addr": self.exit_addr,
                "static_lo": self.static_lo,
                "static_hi": self.static_hi}

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        clk = E["clk"]
        ca1, ca2 = c("carry", 0), c("carry", 1)
        for v in (ca1, ca2, c("st_sel")):
            ctx.constraint(v * (v - 1))
        maddr_lo, maddr_hi = c.lo("maddr"), c.hi("maddr")
        maddrW = maddr_lo + maddr_hi * (1 << 16)
        ctx.constraint(real * (E["b_lo"] + E["imm_lo"] - maddr_lo
                               - ca1 * (1 << 16)))
        ctx.constraint(real * (E["b_hi"] + E["imm_hi"] + ca1 - maddr_hi
                               - ca2 * (1 << 16)))
        lf = [c("l", i) for i in range(4)]
        for v in lf:
            ctx.constraint(v * (v - 1))
        mofs = c("mofs")
        ctx.constraint(real * (c("maddr", 0) - 4 * c("mq") - mofs))
        sb, sh, sw = F[Opcode.SB], F[Opcode.SH], F[Opcode.SW]
        ctx.constraint(sb * (_sum(lf) - 1))
        ctx.constraint(sb * (mofs - lf[1] - 2 * lf[2] - 3 * lf[3]))
        ctx.constraint(sh * (lf[0] + lf[2] - 1))
        ctx.constraint(sh * (lf[1] + lf[3]))
        ctx.constraint(sh * (mofs - 2 * lf[2]))
        ctx.constraint(sw * mofs)
        for i in range(4):
            ctx.constraint(sb * (c("wn", i) - lf[i] * c("c", 0)
                                 - (1 - lf[i]) * c("wp", i)))
            ctx.constraint(sw * (c("wn", i) - c("c", i)))
        ctx.constraint(sh * (c("wn", 0) - lf[0] * c("c", 0)
                             - (1 - lf[0]) * c("wp", 0)))
        ctx.constraint(sh * (c("wn", 1) - lf[0] * c("c", 1)
                             - (1 - lf[0]) * c("wp", 1)))
        ctx.constraint(sh * (c("wn", 2) - lf[2] * c("c", 0)
                             - (1 - lf[2]) * c("wp", 2)))
        ctx.constraint(sh * (c("wn", 3) - lf[2] * c("c", 1)
                             - (1 - lf[2]) * c("wp", 3)))
        # write-region proof: static-RAM window or >= exit_code
        srd = c.word("srd")
        srd2 = c.word("srd2")
        st = c("st_sel")
        ctx.constraint(real * (
            st * (maddrW - ctx.param("exit_addr"))
            + (1 - st) * (maddrW - ctx.param("static_lo")) - srd))
        ctx.constraint(real * (1 - st)
                       * (ctx.param("static_hi") - 1 - maddrW - srd2))
        mtsd = c.word("mtsd")
        ctx.constraint(real * (clk - c("mtsp") - 1 - mtsd))
        self._maddrW = maddrW
        self._mofs = mofs
        return real, E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        real, clk = E["real"], E["clk"]
        alignedW = self._maddrW - self._mofs
        ctx.add_fraction(-real, "mem", [alignedW, c.lo("wp"), c.hi("wp"),
                                        c("mtsp")])
        ctx.add_fraction(real, "mem", [alignedW, c.lo("wn"), c.hi("wn"),
                                       clk])
        ctx.add_fraction(1, "r64", [c("mq")])

    def extra_r256(self):
        return [("maddr", 3), ("wp", 4), ("wn", 4), ("mtsd", 3),
                ("srd", 3), ("srd2", 3)]

    def extra_r64(self):
        return [("maddr", 3), ("mtsd", 3), ("srd", 3), ("srd2", 3)]

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        ctx["uses_rs2"] = np.ones(n, bool)
        ctx["c_val"] = s["c_val"].astype(np.uint64)
        _mem_addr_fill(f, s, n, sel, emits)
        wp = s["mem_prev_val"].astype(np.uint64)
        wn = s["mem_new"].astype(np.uint64)
        _bytes4(f, "wp", wp, slice(0, n))
        _bytes4(f, "wn", wn, slice(0, n))
        clk = s["clk"].astype(np.uint64)
        mtsp = s["mem_prev_ts"].astype(np.uint64)
        f["mtsp"][:n] = mtsp
        _limbs(f, "mtsd", clk - mtsp - 1, slice(0, n))
        lay = view.memory_layout
        raw = s["mem_addr"].astype(np.uint64)
        above = raw >= lay.exit_code
        f["st_sel"][:n] = above
        st_lo = self.static_lo
        st_hi = self.static_hi
        srd = np.where(above, raw - lay.exit_code, raw - st_lo)
        srd2 = np.where(above, 0, st_hi - 1 - raw)
        _limbs(f, "srd", srd, slice(0, n))
        _limbs(f, "srd2", srd2, slice(0, n))
        _emit(emits, "r64", f["mq"].astype(np.int64))


# ---------------------------------------------------------------------------
# Syscalls: ECALL / EBREAK / FENCE (+ the exec-chain boundary)
# ---------------------------------------------------------------------------

class ExSys(_ExecBase):
    """ecall semantics + chain boundary (reference SyscallChip,
    `nexus-zkvm/prover/src/chips/instructions/i/syscall.rs:22`;
    boundary analogue CpuBoundary in prover2)."""
    name = "ex_sys"
    FLAGS = (Opcode.ECALL, Opcode.EBREAK, Opcode.FENCE)
    SYS = [("s_halt", SyscallCode.EXIT),
           ("s_write", SyscallCode.WRITE),
           ("s_cycle", SyscallCode.CYCLE_COUNT),
           ("s_priv", SyscallCode.READ_PRIVATE_INPUT),
           ("s_sp", SyscallCode.OVERWRITE_STACK_POINTER),
           ("s_hp", SyscallCode.OVERWRITE_HEAP_POINTER),
           ("s_advise", SyscallCode.MEMORY_ADVISE)]
    EXTRA = [(name, 1) for name, _ in SYS] + [
        ("reg3", 1), ("wp", 4), ("mtsp", 1), ("mtsd", 4)]

    def __init__(self, entry: int = 0, exit_addr: int = 0,
                 heap_start: int = 0, stack_top: int = 0, seg: int = 0):
        self.entry = int(entry)
        self.exit_addr = int(exit_addr)
        self.heap_start = int(heap_start)
        self.stack_top = int(stack_top)
        self.seg = int(seg)

    def params(self):
        return {"is_entry": 1 if self.seg == 0 else 0,
                "entry": self.entry,
                "exit_addr": self.exit_addr,
                "heap_lo": self.heap_start & 0xFFFF,
                "heap_hi": self.heap_start >> 16,
                "stack_lo": self.stack_top & 0xFFFF,
                "stack_hi": self.stack_top >> 16}

    def uses_rs2(self, F, E):
        return F[Opcode.ECALL]

    def writes(self, F, E):
        return E["s_write"] + E["s_priv"] + E["s_sp"] + E["s_hp"]

    def reg3(self, c, F, E):
        return c("reg3")

    def body(self, ctx, c, E):
        F = E["F"]
        real = E["real"]
        clk = E["clk"]
        S = {name: c(name) for name, _ in self.SYS}
        E.update(S)
        for name, code in self.SYS:
            ctx.constraint(S[name] * (S[name] - 1))
            ctx.constraint(S[name] * (E["b_lo"] - int(code)))
            ctx.constraint(S[name] * E["b_hi"])
        ctx.constraint(_sum(list(S.values())) - F[Opcode.ECALL])
        # write destination: a0 (x10), or sp (x2) for OverwriteStackPtr
        ctx.constraint(F[Opcode.ECALL] * (c("reg3") - 10 + 8 * S["s_sp"]))
        ctx.constraint(S["s_sp"] * (E["a_lo"] - ctx.param("stack_lo")))
        ctx.constraint(S["s_sp"] * (E["a_hi"] - ctx.param("stack_hi")))
        ctx.constraint(S["s_hp"] * (E["a_lo"] - ctx.param("heap_lo")))
        ctx.constraint(S["s_hp"] * (E["a_hi"] - ctx.param("heap_hi")))
        mtsd = c.word("mtsd")
        ctx.constraint(S["s_halt"] * (clk - c("mtsp") - 1 - mtsd))
        # exec-chain boundary: emit the entry state on the first row
        ctx.add_fraction(ctx.is_first * ctx.param("is_entry"), "exec",
                         [1, ctx.param("entry")])
        return real - S["s_halt"], E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        # the halting row writes the exit value (a0) to the exit word
        clk = E["clk"]
        s_halt = E["s_halt"]
        exit_addr = ctx.param("exit_addr")
        ctx.add_fraction(-s_halt, "mem", [exit_addr, c.lo("wp"),
                                          c.hi("wp"), c("mtsp")])
        ctx.add_fraction(s_halt, "mem", [exit_addr, E["c_lo"],
                                         E["c_hi"], clk])

    def extra_r256(self):
        return [("wp", 4), ("mtsd", 3)]

    def extra_r64(self):
        return [("mtsd", 3)]

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        is_ecall = sel(Opcode.ECALL)
        b_val = s["b_val"].astype(np.uint64)
        for name, code in self.SYS:
            f[name][:n] = is_ecall & (b_val == int(code))
        s_halt = f["s_halt"][:n].astype(bool)
        # program-table op_a for ECALL is a0 (decode_program_table);
        # op_b/op_c follow rs1=17/rs2=10 from the decoder already
        f["opa"][:n] = np.where(is_ecall, 10, s["rd"])
        reg3 = np.where(is_ecall,
                        np.where(f["s_sp"][:n].astype(bool), 2, 10),
                        s["rd"])
        ctx["reg3"] = reg3.astype(np.uint32)
        ctx["uses_rs2"] = is_ecall
        ctx["c_val"] = np.where(is_ecall,
                                s["c_val"].astype(np.uint64), 0)
        ctx["writes"] = (f["s_write"][:n] | f["s_priv"][:n]
                         | f["s_sp"][:n] | f["s_hp"][:n]).astype(bool)
        wp = np.where(s_halt, s["mem_prev_val"].astype(np.uint64), 0)
        _bytes4(f, "wp", wp, slice(0, n))
        clk = s["clk"].astype(np.uint64)
        mtsp = np.where(s_halt, s["mem_prev_ts"].astype(np.uint64), 0)
        f["mtsp"][:n] = mtsp
        _limbs(f, "mtsd", np.where(s_halt, clk - mtsp - 1, 0),
               slice(0, n))


# ---------------------------------------------------------------------------
# Dispatch families: M-ext / keccakf / dynamic precompiles
# ---------------------------------------------------------------------------

class ExMext(_ExecBase):
    """M-extension dispatch; the arithmetic lives in MExtComponent
    (`machine/mext.py`), consumed through the `mext` relation."""
    name = "ex_mext"
    FLAGS = (Opcode.MUL, Opcode.MULH, Opcode.MULHSU, Opcode.MULHU,
             Opcode.DIV, Opcode.DIVU, Opcode.REM, Opcode.REMU)
    EXTRA = []

    def body(self, ctx, c, E):
        return E["real"], E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        opid = _sum([E["F"][op] * int(op) for op in self.FLAGS])
        ctx.add_fraction(E["real"], "mext",
                         [opid, E["b_lo"], E["b_hi"], E["c_lo"],
                          E["c_hi"], E["a_lo"], E["a_hi"]])

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        ctx["uses_rs2"] = np.ones(n, bool)
        ctx["writes"] = np.ones(n, bool)
        ctx["c_val"] = s["c_val"].astype(np.uint64)


class ExKeccak(_ExecBase):
    """keccakf dispatch; the permutation circuit is KeccakComponent
    (`machine/keccak.py`), consumed through the `keccak` relation.
    keccakf writes its result to RAM, never to rd (the emulator's
    write-back returns False) — so there is no write block."""
    name = "ex_keccak"
    FLAGS = (Opcode.KECCAKF,)
    HAS_WRITE = False
    EXTRA = []

    def body(self, ctx, c, E):
        return E["real"], E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        ctx.add_fraction(E["real"], "keccak",
                         [E["clk"], E["b_lo"], E["b_hi"]])

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        ctx["uses_rs2"] = np.ones(n, bool)
        ctx["c_val"] = s["c_val"].astype(np.uint64)


class ExPrecomp(_ExecBase):
    """Dynamic-precompile dispatch through the `precomp` relation
    (reference `PrecompileInstruction::circuit`,
    `nexus-zkvm/precompiles/src/traits.rs:38-46`)."""
    name = "ex_precomp"
    FLAGS = (Opcode.PRECOMPILE,)
    EXTRA = []

    def body(self, ctx, c, E):
        return E["real"], E["pcW"] + 4

    def extra_fractions(self, ctx, c, E):
        ctx.add_fraction(E["real"], "precomp",
                         [E["imm_lo"], E["b_lo"], E["b_hi"], E["c_lo"],
                          E["c_hi"], E["a_lo"], E["a_hi"]])

    def fill_body(self, f, s, n, sel, view, ctx, emits):
        ctx["uses_rs2"] = np.ones(n, bool)
        ctx["writes"] = np.ones(n, bool)
        ctx["c_val"] = s["c_val"].astype(np.uint64)


EXEC_FAMILIES = [ExAlu, ExBit, ExShift, ExCmp, ExBranch, ExJump,
                 ExLoad, ExStore, ExSys, ExMext, ExKeccak, ExPrecomp]


def family_rows(opcodes: np.ndarray, family) -> np.ndarray:
    """Boolean mask of the trace rows belonging to `family`."""
    m = np.zeros(len(opcodes), bool)
    for op in family.FLAGS:
        m |= opcodes == int(op)
    return m


def fill_family(comp, trace_steps, rows, log_size, view):
    """Extract `rows` of the SoA steps and run the family fill."""
    idx = np.flatnonzero(rows)
    s = {k: v[idx] for k, v in trace_steps.items()}
    return comp.fill(s, len(idx), 1 << log_size, view, {})

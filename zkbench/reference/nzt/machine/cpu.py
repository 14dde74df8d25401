"""The CPU component: per-step constraints for the full RV32I base set.

Counterpart of the reference's 28-chip main machine component
(`nexus-zkvm/prover/src/machine.rs:49-79`, chips under
`prover/src/chips/`), re-architected:

* **Fetch/decode via preprocessed program table** — the `prog` relation
  tuple (pc, opcode_id, op_a, op_b, op_c, imm_lo, imm_hi) is provided
  by `ProgramTable` (verifier-recomputed), replacing the reference's
  in-circuit DecodingCheckChip (`prover/src/chips/decoding/`).
* **Execution chain** — `exec` relation (clk, pc): the boundary emits
  (1, entry) on the first row; every real step consumes its own state
  and emits (clk+1, next_pc) unless halting, so exactly one halt ends
  the chain (CpuChip + SyscallChip pc-next logic,
  `prover/src/chips/cpu.rs:33`).
* **Register file** — `reg` relation (r, v_lo, v_hi, ts), three access
  slots per step at ts = 3*clk + {1,2,3}
  (`prover/src/chips/memory_check/register_mem_check.rs:32-110`), with
  ts-ordering enforced by range-checked differences (TimestampChip,
  `prover/src/chips/memory_check/timestamp.rs:32`).
* **RAM** — `mem` relation (addr, v_lo, v_hi, ts), word-granular with
  byte-lane mux for LB/LH/SB/SH (LoadStoreChip,
  `prover/src/chips/instructions/i/load_store.rs:64`), and
  write/read-region range proofs standing in for the emulator's memory
  protection modes.
* **Byte shifts via SHL8/SHR8 lookup tables** instead of committed
  exponent products (`prover/src/chips/instructions/i/sll.rs`).

Soundness invariants documented inline: every committed limb that
participates in carry arithmetic is range-checked so carries are
forced; addresses and pcs stay < 2^30 so M31 aliasing is impossible;
clk < 2^28 keeps every timestamp < TS_CHECK.
"""

from __future__ import annotations

import numpy as np

from ..air import Component
from ..vm.isa import Opcode, SyscallCode
from .schema import Schema, Cols

__all__ = ["CpuComponent", "ProgramTable", "CPU_SCHEMA", "OP_FLAGS",
           "decode_program_table"]

# Opcode flags in schema order.  M-extension ops dispatch to the
# separate MExtComponent through the `mext` relation (prover2-style,
# `nexus-zkvm/prover2/machine/src/components/execution/`).
OP_FLAGS = [
    Opcode.ADD, Opcode.SUB, Opcode.SLL, Opcode.SLT, Opcode.SLTU,
    Opcode.XOR, Opcode.SRL, Opcode.SRA, Opcode.OR, Opcode.AND,
    Opcode.ADDI, Opcode.SLLI, Opcode.SLTI, Opcode.SLTIU, Opcode.XORI,
    Opcode.SRLI, Opcode.SRAI, Opcode.ORI, Opcode.ANDI,
    Opcode.LB, Opcode.LH, Opcode.LW, Opcode.LBU, Opcode.LHU,
    Opcode.JALR, Opcode.ECALL, Opcode.EBREAK, Opcode.FENCE,
    Opcode.SB, Opcode.SH, Opcode.SW,
    Opcode.BEQ, Opcode.BNE, Opcode.BLT, Opcode.BGE, Opcode.BLTU,
    Opcode.BGEU, Opcode.LUI, Opcode.AUIPC, Opcode.JAL,
    Opcode.MUL, Opcode.MULH, Opcode.MULHSU, Opcode.MULHU,
    Opcode.DIV, Opcode.DIVU, Opcode.REM, Opcode.REMU,
    Opcode.KECCAKF, Opcode.PRECOMPILE,
]
_FLAG_IDX = {op: i for i, op in enumerate(OP_FLAGS)}

SYS_FLAGS = [("s_halt", SyscallCode.EXIT),
             ("s_write", SyscallCode.WRITE),
             ("s_cycle", SyscallCode.CYCLE_COUNT),
             ("s_priv", SyscallCode.READ_PRIVATE_INPUT),
             ("s_sp", SyscallCode.OVERWRITE_STACK_POINTER),
             ("s_hp", SyscallCode.OVERWRITE_HEAP_POINTER),
             ("s_advise", SyscallCode.MEMORY_ADVISE)]

CPU_SCHEMA = Schema(
    [("f", len(OP_FLAGS))] +
    [(name, 1) for name, _ in SYS_FLAGS] +
    [
        ("pad", 1),
        ("clk", 1),
        ("pc", 4), ("npc", 4),           # byte limbs (range-checked)
        ("imm", 4),
        ("opa", 1), ("opb", 1), ("opc", 1), ("reg3", 1),
        ("nz", 1), ("inv_a", 1),
        ("a", 4), ("b", 4), ("c", 4),
        ("a_prev_lo", 1), ("a_prev_hi", 1),
        ("ts1p", 1), ("ts2p", 1), ("ts3p", 1),
        ("tsd1", 4), ("tsd2", 4), ("tsd3", 4),   # limbs 8/8/8/6
        ("carry_a", 2), ("carry_pc", 2), ("lsb", 1),
        # compare block
        ("sgn_b", 1), ("sgn_c", 1), ("b3l7", 1), ("c3l7", 1),
        ("sgn_xor", 1), ("br1", 1), ("br2", 1), ("h", 4),
        ("e_lo", 1), ("i_lo", 1), ("e_hi", 1), ("i_hi", 1),
        # bitwise nibble-high columns
        ("bh", 4), ("ch", 4), ("ah", 4),
        # shift block
        ("c0q", 1), ("sh_r", 1), ("q", 4),
        ("sh_x", 4), ("sh_y", 4), ("sh_rem", 4),
        ("sh_ph", 1), ("sh_p", 1),
        # memory block
        ("maddr", 4), ("mq", 1), ("mofs", 1), ("l", 4),
        ("wp", 4), ("wn", 4),
        ("mtsp", 1), ("mtsd", 4),
        ("ld_s", 1), ("ld_l7", 1),
        ("srd", 4), ("srd2", 4), ("ls_sel", 1), ("st_sel", 1),
    ])


def _sum(fs):
    acc = fs[0]
    for f in fs[1:]:
        acc = acc + f
    return acc


class CpuComponent(Component):
    """One execution segment.  Multi-segment proofs instantiate several
    of these (`seg > 0` suppresses the boundary emit); the exec / reg /
    mem chains connect across segments through the shared relations —
    the TPU-native rendering of the reference's trace `split_by` seam
    (`nexus-zkvm/vm/src/trace.rs:108-120`)."""
    name = "cpu"
    family = "cpu"             # every segment's tapes: one K7 source each
    n_main = CPU_SCHEMA.n_cols

    def __init__(self, entry: int, exit_addr: int, heap_start: int,
                 stack_top: int, static_lo: int | None = None,
                 static_hi: int | None = None, seg: int = 0):
        self.seg = int(seg)
        self.name = "cpu" if seg == 0 else f"cpu{seg}"
        self.entry = int(entry)
        self.exit_addr = int(exit_addr)
        self.heap_start = int(heap_start)
        self.stack_top = int(stack_top)
        # static-RAM store window; degenerate (empty) when absent
        self.static_lo = int(static_lo if static_lo is not None
                             else exit_addr)
        self.static_hi = int(static_hi if static_hi is not None
                             else exit_addr)

    def jit_key(self):
        # segments share compiled graphs (only params differ)
        return (type(self).__module__, type(self).__qualname__,
                "cpu", self.n_main)

    def params(self):
        return {
            "is_entry": 1 if self.seg == 0 else 0,
            "entry": self.entry,
            "exit_addr": self.exit_addr,
            "heap_start": self.heap_start,
            "heap_lo": self.heap_start & 0xFFFF,
            "heap_hi": self.heap_start >> 16,
            "stack_lo": self.stack_top & 0xFFFF,
            "stack_hi": self.stack_top >> 16,
            "static_lo": self.static_lo,
            "static_hi": self.static_hi,
        }

    # -- helpers --------------------------------------------------------
    def evaluate(self, ctx):
        c = Cols(ctx, CPU_SCHEMA)
        F = {op: c("f", i) for op, i in _FLAG_IDX.items()}
        S = {name: c(name) for name, _ in SYS_FLAGS}
        pad = c("pad")
        real = 1 - pad
        clk = c("clk")

        # booleanity
        for op in OP_FLAGS:
            ctx.constraint(F[op] * (F[op] - 1))
        for name, _ in SYS_FLAGS:
            ctx.constraint(S[name] * (S[name] - 1))
        ctx.constraint(pad * (pad - 1))
        for name in ("br1", "br2", "e_lo", "e_hi", "sgn_b", "sgn_c",
                     "lsb", "nz", "ls_sel"):
            ctx.constraint(c(name) * (c(name) - 1))
        for i in range(2):
            ctx.constraint(c("carry_a", i) * (c("carry_a", i) - 1))
            ctx.constraint(c("carry_pc", i) * (c("carry_pc", i) - 1))
        for i in range(4):
            ctx.constraint(c("q", i) * (c("q", i) - 1))
            ctx.constraint(c("l", i) * (c("l", i) - 1))
        # exactly one opcode flag on real rows
        ctx.constraint(_sum([F[op] for op in OP_FLAGS]) - real)
        ctx.constraint(_sum([S[n] for n, _ in SYS_FLAGS])
                       - F[Opcode.ECALL])

        # limb combinations
        pc_lo, pc_hi = c.lo("pc"), c.hi("pc")
        npc_lo, npc_hi = c.lo("npc"), c.hi("npc")
        imm_lo, imm_hi = c.lo("imm"), c.hi("imm")
        a_lo, a_hi = c.lo("a"), c.hi("a")
        b_lo, b_hi = c.lo("b"), c.hi("b")
        c_lo, c_hi = c.lo("c"), c.hi("c")
        pcW = pc_lo + pc_hi * (1 << 16)
        maddr_lo, maddr_hi = c.lo("maddr"), c.hi("maddr")
        maddrW = maddr_lo + maddr_hi * (1 << 16)

        # -- virtual flag classes --------------------------------------
        is_load = _sum([F[o] for o in (Opcode.LB, Opcode.LH, Opcode.LW,
                                       Opcode.LBU, Opcode.LHU)])
        is_store = _sum([F[o] for o in (Opcode.SB, Opcode.SH, Opcode.SW)])
        is_branch = _sum([F[o] for o in (Opcode.BEQ, Opcode.BNE,
                                         Opcode.BLT, Opcode.BGE,
                                         Opcode.BLTU, Opcode.BGEU)])
        is_mem = is_load + is_store + S["s_halt"]
        m_ext = _sum([F[o] for o in (
            Opcode.MUL, Opcode.MULH, Opcode.MULHSU, Opcode.MULHU,
            Opcode.DIV, Opcode.DIVU, Opcode.REM, Opcode.REMU)])
        uses_rs2 = m_ext + _sum([F[o] for o in (
            Opcode.ADD, Opcode.SUB, Opcode.SLL, Opcode.SLT, Opcode.SLTU,
            Opcode.XOR, Opcode.SRL, Opcode.SRA, Opcode.OR, Opcode.AND,
            Opcode.SB, Opcode.SH, Opcode.SW, Opcode.BEQ, Opcode.BNE,
            Opcode.BLT, Opcode.BGE, Opcode.BLTU, Opcode.BGEU,
            Opcode.ECALL, Opcode.KECCAKF, Opcode.PRECOMPILE)])
        writes = F[Opcode.PRECOMPILE] + m_ext + _sum([F[o] for o in (
            Opcode.ADD, Opcode.SUB, Opcode.SLL, Opcode.SLT, Opcode.SLTU,
            Opcode.XOR, Opcode.SRL, Opcode.SRA, Opcode.OR, Opcode.AND,
            Opcode.ADDI, Opcode.SLLI, Opcode.SLTI, Opcode.SLTIU,
            Opcode.XORI, Opcode.SRLI, Opcode.SRAI, Opcode.ORI,
            Opcode.ANDI, Opcode.LB, Opcode.LH, Opcode.LW, Opcode.LBU,
            Opcode.LHU, Opcode.JAL, Opcode.JALR, Opcode.LUI,
            Opcode.AUIPC)]) \
            + S["s_write"] + S["s_priv"] + S["s_sp"] + S["s_hp"]
        imm_c = _sum([F[o] for o in (
            Opcode.ADDI, Opcode.SLLI, Opcode.SLTI, Opcode.SLTIU,
            Opcode.XORI, Opcode.SRLI, Opcode.SRAI, Opcode.ORI,
            Opcode.ANDI, Opcode.FENCE)])
        cmp_on = is_branch + _sum([F[o] for o in (
            Opcode.SLT, Opcode.SLTU, Opcode.SLTI, Opcode.SLTIU)])
        sll_cls = F[Opcode.SLL] + F[Opcode.SLLI]
        srl_cls = F[Opcode.SRL] + F[Opcode.SRLI]
        sra_cls = F[Opcode.SRA] + F[Opcode.SRAI]
        shr_cls = srl_cls + sra_cls
        shift_cls = sll_cls + shr_cls

        # c carries the immediate for I-type ALU ops
        for i in range(4):
            ctx.constraint(imm_c * (c("c", i) - c("imm", i)))

        # -- program fetch ---------------------------------------------
        opid = _sum([F[op] * int(op) for op in OP_FLAGS])
        ctx.add_fraction(real, "prog",
                         [pcW, opid, c("opa"), c("opb"), c("opc"),
                          imm_lo, imm_hi])

        # -- M-extension dispatch (consumed by MExtComponent) ----------
        ctx.add_fraction(m_ext, "mext",
                         [opid, b_lo, b_hi, c_lo, c_hi, a_lo, a_hi])

        # -- keccakf dispatch (consumed by KeccakComponent) ------------
        ctx.add_fraction(F[Opcode.KECCAKF], "keccak", [clk, b_lo, b_hi])

        # -- dynamic precompile dispatch (consumed by the precompile's
        # circuit component; the index is the decoded immediate, bound
        # to the public program by the fetch lookup) -------------------
        ctx.add_fraction(F[Opcode.PRECOMPILE], "precomp",
                         [imm_lo, b_lo, b_hi, c_lo, c_hi, a_lo, a_hi])

        # -- execution chain (boundary emit only in the entry segment) --
        ctx.add_fraction(ctx.is_first * ctx.param("is_entry"), "exec",
                         [1, ctx.param("entry")])
        ctx.add_fraction(-real, "exec", [clk, pcW])
        ctx.add_fraction(real - S["s_halt"], "exec",
                         [clk + 1, npc_lo + npc_hi * (1 << 16)])

        # next-pc selection:
        #   T = 1 on taken branches and jumps; base = pc (b for JALR)
        eq = c("e_lo") * c("e_hi")
        lt_s = c("br2") + c("sgn_xor") \
            - 2 * c("br2") * c("sgn_xor")
        T = F[Opcode.BEQ] * eq + F[Opcode.BNE] * (1 - eq) \
            + F[Opcode.BLT] * lt_s + F[Opcode.BGE] * (1 - lt_s) \
            + F[Opcode.BLTU] * c("br2") + F[Opcode.BGEU] * (1 - c("br2")) \
            + F[Opcode.JAL] + F[Opcode.JALR]
        jr = F[Opcode.JALR]
        base_lo = pc_lo + jr * (b_lo - pc_lo)
        base_hi = pc_hi + jr * (b_hi - pc_hi)
        cp1, cp2 = c("carry_pc", 0), c("carry_pc", 1)
        # holds on padding too ((1-T)*4 - 4*pad = 0 there), so no `real`
        # gating is needed and the degree stays within the bound
        ctx.constraint(base_lo + T * imm_lo
                       + (1 - T) * 4 - 4 * S["s_halt"] - 4 * pad
                       - jr * c("lsb")
                       - npc_lo - cp1 * (1 << 16))
        ctx.constraint(base_hi + T * imm_hi + cp1
                       - npc_hi - cp2 * (1 << 16))

        # -- register access slots -------------------------------------
        ts1, ts2, ts3 = 3 * clk + 1, 3 * clk + 2, 3 * clk + 3
        ctx.add_fraction(-real, "reg", [c("opb"), b_lo, b_hi, c("ts1p")])
        ctx.add_fraction(real, "reg", [c("opb"), b_lo, b_hi, ts1])
        ctx.add_fraction(-uses_rs2, "reg", [c("opc"), c_lo, c_hi,
                                            c("ts2p")])
        ctx.add_fraction(uses_rs2, "reg", [c("opc"), c_lo, c_hi, ts2])
        # slot 3: writes go through the effective value (x0 stays 0)
        ctx.constraint(c("reg3") * c("inv_a") - c("nz"))
        ctx.constraint(c("reg3") * (1 - c("nz")))
        ctx.constraint(F[Opcode.ECALL] * (c("reg3") - 10 + 8 * S["s_sp"]))
        ctx.constraint((real - F[Opcode.ECALL]) * (c("reg3") - c("opa")))
        ae_lo, ae_hi = a_lo * c("nz"), a_hi * c("nz")
        ctx.add_fraction(-writes, "reg", [c("reg3"), c("a_prev_lo"),
                                          c("a_prev_hi"), c("ts3p")])
        ctx.add_fraction(writes, "reg", [c("reg3"), ae_lo, ae_hi, ts3])

        # timestamp ordering (ts_prev < ts_cur), range-checked diffs
        for slot, (mult, tsp, tsc) in enumerate(
                [(real, c("ts1p"), ts1), (uses_rs2, c("ts2p"), ts2),
                 (writes, c("ts3p"), ts3)]):
            name = f"tsd{slot + 1}"
            d = c(name, 0) + c(name, 1) * (1 << 8) \
                + c(name, 2) * (1 << 16) + c(name, 3) * (1 << 24)
            ctx.constraint(mult * (tsc - tsp - 1 - d))

        # -- ALU ------------------------------------------------------
        ca1, ca2 = c("carry_a", 0), c("carry_a", 1)
        addc = F[Opcode.ADD] + F[Opcode.ADDI]
        ctx.constraint(addc * (b_lo + c_lo - a_lo - ca1 * (1 << 16)))
        ctx.constraint(addc * (b_hi + c_hi + ca1 - a_hi
                               - ca2 * (1 << 16)))
        ctx.constraint(F[Opcode.SUB] * (b_lo - c_lo + ca1 * (1 << 16)
                                        - a_lo))
        ctx.constraint(F[Opcode.SUB] * (b_hi - c_hi - ca1
                                        + ca2 * (1 << 16) - a_hi))
        # link register for jumps: a = pc + 4
        link = F[Opcode.JAL] + F[Opcode.JALR]
        ctx.constraint(link * (pc_lo + 4 - a_lo - ca1 * (1 << 16)))
        ctx.constraint(link * (pc_hi + ca1 - a_hi - ca2 * (1 << 16)))
        # lui / auipc
        for i in range(4):
            ctx.constraint(F[Opcode.LUI] * (c("a", i) - c("imm", i)))
        ctx.constraint(F[Opcode.AUIPC] * (pc_lo + imm_lo - a_lo
                                          - ca1 * (1 << 16)))
        ctx.constraint(F[Opcode.AUIPC] * (pc_hi + imm_hi + ca1 - a_hi
                                          - ca2 * (1 << 16)))

        # bitwise via nibble tables: each byte splits into committed
        # high nibbles (bound [0,16) by the lookups) and derived lows
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

        # -- compare block ---------------------------------------------
        h_lo, h_hi = c.lo("h"), c.hi("h")
        ctx.constraint(cmp_on * (b_lo - c_lo + c("br1") * (1 << 16)
                                 - h_lo))
        ctx.constraint(cmp_on * (b_hi - c_hi - c("br1")
                                 + c("br2") * (1 << 16) - h_hi))
        ctx.constraint(c("e_lo") * h_lo)
        ctx.constraint(h_lo * c("i_lo") - (1 - c("e_lo")))
        ctx.constraint(c("e_hi") * h_hi)
        ctx.constraint(h_hi * c("i_hi") - (1 - c("e_hi")))
        # sign decomposition of the top bytes of b and c
        sgn_need = cmp_on + sra_cls + F[Opcode.LB] + F[Opcode.LH]
        ctx.constraint(sgn_need * (c("b", 3) - 128 * c("sgn_b")
                                   - c("b3l7")))
        ctx.constraint(cmp_on * (c("c", 3) - 128 * c("sgn_c")
                                 - c("c3l7")))
        ctx.constraint(c("sgn_xor") - c("sgn_b") - c("sgn_c")
                       + 2 * c("sgn_b") * c("sgn_c"))
        # slt/sltu results
        sltu_cls = F[Opcode.SLTU] + F[Opcode.SLTIU]
        slt_cls = F[Opcode.SLT] + F[Opcode.SLTI]
        ctx.constraint(sltu_cls * (c("a", 0) - c("br2")))
        ctx.constraint(slt_cls * (c("a", 0) - lt_s))
        for i in range(1, 4):
            ctx.constraint((sltu_cls + slt_cls) * c("a", i))

        # -- shifts ----------------------------------------------------
        # shamt s = c0 mod 32 = 8*(q1 + 2 q2 + 3 q3) + r, c0q = c0 >> 5
        qs = [c("q", i) for i in range(4)]
        ctx.constraint(shift_cls * (_sum(qs) - 1))
        ctx.constraint(shift_cls * (
            c("c", 0) - 32 * c("c0q")
            - 8 * (qs[1] + 2 * qs[2] + 3 * qs[3]) - c("sh_r")))
        ctx.add_fraction(shift_cls, "r8", [c("c0q")])
        for i in range(4):
            # SLL: b_i * 2^r = sh_x_i * 256 + sh_y_i
            ctx.add_fraction(sll_cls, "shl8",
                             [c("b", i), c("sh_r"), c("sh_x", i),
                              c("sh_y", i)])
            # SRL/SRA: b_i = sh_x_i * 2^r + sh_rem_i ; carry-in from the
            # byte above: sh_rem_{i} * 2^(8-r) = sh_y_i
            ctx.add_fraction(shr_cls, "shr8",
                             [c("b", i), c("sh_r"), c("sh_x", i),
                              c("sh_rem", i)])
            ctx.add_fraction(shr_cls, "shl8",
                             [c("sh_rem", i), 8 - c("sh_r"), 0,
                              c("sh_y", i)])
        # SRA sign fill: sh_p(+256 sh_ph) = 2^(8-r); fill = 256 - p
        ctx.add_fraction(sra_cls, "shl8",
                         [1, 8 - c("sh_r"), c("sh_ph"), c("sh_p")])
        fill = 256 - c("sh_p") - 256 * c("sh_ph")
        # byte-lane mux by q
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
                    t = tr[k] + (c("sgn_b") * fill if j + k == 3 else 0)
                    sra_terms.append(qs[k] * t)
                else:
                    sra_terms.append(qs[k] * (c("sgn_b") * 255))
            ctx.constraint(sra_cls * (c("a", j) - _sum(sra_terms)))

        # -- memory ----------------------------------------------------
        mem_b = F[Opcode.LB] + F[Opcode.LBU] + F[Opcode.SB]
        mem_h = F[Opcode.LH] + F[Opcode.LHU] + F[Opcode.SH]
        mem_w = F[Opcode.LW] + F[Opcode.SW]
        ls = is_load + is_store
        # address arithmetic: maddr = b + imm (mod 2^32); carry_a is
        # free here (loads/stores are not ALU-add/sub/jump rows)
        cm1 = c("carry_a", 0)
        cm2 = c("carry_a", 1)
        ctx.constraint(ls * (b_lo + imm_lo - maddr_lo
                             - cm1 * (1 << 16)))
        ctx.constraint(ls * (b_hi + imm_hi + cm1 - maddr_hi
                             - cm2 * (1 << 16)))
        exit_addr = ctx.param("exit_addr")
        heap_start = ctx.param("heap_start")
        ctx.constraint(S["s_halt"] * (maddrW - exit_addr))
        # alignment + lane one-hot; mofs = byte offset within the word
        lf = [c("l", i) for i in range(4)]
        mofs = c("mofs")
        ctx.constraint(is_mem * (c("maddr", 0) - 4 * c("mq") - mofs))
        ctx.constraint(mem_b * (_sum(lf) - 1))
        ctx.constraint(mem_b * (mofs - lf[1] - 2 * lf[2] - 3 * lf[3]))
        ctx.constraint(mem_h * (lf[0] + lf[2] - 1))
        ctx.constraint(mem_h * (lf[1] + lf[3]))
        ctx.constraint(mem_h * (mofs - 2 * lf[2]))
        ctx.constraint((mem_w + S["s_halt"]) * mofs)
        ctx.add_fraction(1, "r64", [c("mq")])
        # load value extraction
        src_b = _sum([lf[i] * c("wp", i) for i in range(4)])
        src_h_lo = lf[0] * c("wp", 0) + lf[2] * c("wp", 2)
        src_h_hi = lf[0] * c("wp", 1) + lf[2] * c("wp", 3)
        sign_src = F[Opcode.LB] * src_b + F[Opcode.LH] * src_h_hi
        ctx.constraint((F[Opcode.LB] + F[Opcode.LH])
                       * (sign_src - 128 * c("ld_s") - c("ld_l7")))
        ctx.constraint(c("ld_s") * (c("ld_s") - 1))
        ctx.add_fraction(1, "r128", [c("ld_l7")])
        ctx.add_fraction(1, "r128", [c("b3l7")])
        ctx.add_fraction(1, "r128", [c("c3l7")])
        lbu = F[Opcode.LBU]
        lb_, lh_, lhu = F[Opcode.LB], F[Opcode.LH], F[Opcode.LHU]
        ctx.constraint((lb_ + lbu) * (c("a", 0) - src_b))
        ctx.constraint((lh_ + lhu) * (c("a", 0) - src_h_lo))
        ctx.constraint((lh_ + lhu) * (c("a", 1) - src_h_hi))
        ctx.constraint(lb_ * (c("a", 1) - 255 * c("ld_s")))
        ctx.constraint((lb_ + lh_) * (c("a", 2) - 255 * c("ld_s")))
        ctx.constraint((lb_ + lh_) * (c("a", 3) - 255 * c("ld_s")))
        ctx.constraint(lbu * (c("a", 1)))
        ctx.constraint((lbu + lhu) * (c("a", 2)))
        ctx.constraint((lbu + lhu) * (c("a", 3)))
        ctx.constraint(F[Opcode.LW] * (c("a", 0) - c("wp", 0)))
        ctx.constraint(F[Opcode.LW] * (c("a", 1) - c("wp", 1)))
        ctx.constraint(F[Opcode.LW] * (c("a", 2) - c("wp", 2)))
        ctx.constraint(F[Opcode.LW] * (c("a", 3) - c("wp", 3)))
        # new-word composition
        for i in range(4):
            ctx.constraint(is_load * (c("wn", i) - c("wp", i)))
            ctx.constraint(F[Opcode.SB] * (
                c("wn", i) - lf[i] * c("c", 0)
                - (1 - lf[i]) * c("wp", i)))
            ctx.constraint(S["s_halt"] * (c("wn", i) - c("c", i)))
            ctx.constraint(F[Opcode.SW] * (c("wn", i) - c("c", i)))
        sh_f = F[Opcode.SH]
        ctx.constraint(sh_f * (c("wn", 0) - lf[0] * c("c", 0)
                               - (1 - lf[0]) * c("wp", 0)))
        ctx.constraint(sh_f * (c("wn", 1) - lf[0] * c("c", 1)
                               - (1 - lf[0]) * c("wp", 1)))
        ctx.constraint(sh_f * (c("wn", 2) - lf[2] * c("c", 0)
                               - (1 - lf[2]) * c("wp", 2)))
        ctx.constraint(sh_f * (c("wn", 3) - lf[2] * c("c", 1)
                               - (1 - lf[2]) * c("wp", 3)))
        # memory-protection region proofs: stores must land in the
        # static-RAM window or at/above the exit-code word; loads must
        # avoid the write-only [exit_code, heap) window
        srd = c("srd", 0) + c("srd", 1) * (1 << 8) \
            + c("srd", 2) * (1 << 16) + c("srd", 3) * (1 << 24)
        srd2 = c("srd2", 0) + c("srd2", 1) * (1 << 8) \
            + c("srd2", 2) * (1 << 16) + c("srd2", 3) * (1 << 24)
        st = c("st_sel")
        ctx.constraint(st * (st - 1))
        ctx.constraint((is_store + S["s_halt"]) * (
            st * (maddrW - exit_addr)
            + (1 - st) * (maddrW - ctx.param("static_lo")) - srd))
        ctx.constraint(is_store * (1 - st)
                       * (ctx.param("static_hi") - 1 - maddrW - srd2))
        sel = c("ls_sel")
        ctx.constraint(is_load * (
            sel * (exit_addr - 1 - maddrW)
            + (1 - sel) * (maddrW - heap_start) - srd))
        # the access chain (word-aligned address)
        alignedW = maddrW - mofs
        wp_lo, wp_hi = c.lo("wp"), c.hi("wp")
        wn_lo, wn_hi = c.lo("wn"), c.hi("wn")
        ctx.add_fraction(-is_mem, "mem", [alignedW, wp_lo, wp_hi,
                                          c("mtsp")])
        ctx.add_fraction(is_mem, "mem", [alignedW, wn_lo, wn_hi, clk])
        mtsd = c("mtsd", 0) + c("mtsd", 1) * (1 << 8) \
            + c("mtsd", 2) * (1 << 16) + c("mtsd", 3) * (1 << 24)
        ctx.constraint(is_mem * (clk - c("mtsp") - 1 - mtsd))

        # -- syscalls --------------------------------------------------
        for name, code in SYS_FLAGS:
            ctx.constraint(S[name] * (b_lo - int(code)))
            ctx.constraint(S[name] * b_hi)
        ctx.constraint(S["s_sp"] * (a_lo - ctx.param("stack_lo")))
        ctx.constraint(S["s_sp"] * (a_hi - ctx.param("stack_hi")))
        ctx.constraint(S["s_hp"] * (a_lo - ctx.param("heap_lo")))
        ctx.constraint(S["s_hp"] * (a_hi - ctx.param("heap_hi")))

        # -- byte range checks -----------------------------------------
        r256 = []
        for name in ("a", "b", "c", "imm", "wp", "wn", "h"):
            r256 += [c(name, i) for i in range(4)]
        r256 += [c("pc", i) for i in range(3)]
        r256 += [c("npc", i) for i in range(3)]
        r256 += [c("maddr", i) for i in range(3)]
        for name in ("tsd1", "tsd2", "tsd3", "mtsd", "srd", "srd2"):
            r256 += [c(name, i) for i in range(3)]
        for v in r256:
            ctx.add_fraction(1, "r256", [v])
        for name in ("pc", "npc", "maddr", "tsd1", "tsd2", "tsd3",
                     "mtsd", "srd", "srd2"):
            ctx.add_fraction(1, "r64", [c(name, 3)])


class ProgramTable(Component):
    """Preprocessed decoded program; provides the `prog` relation.

    Replaces the reference's committed program trace + in-circuit
    decoding (`prover/src/trace/program_trace.rs`,
    `prover/src/chips/decoding/`): the table is recomputed by the
    verifier from the public View.
    """
    name = "program"
    n_main = 1

    def __init__(self, table: dict):
        self.table = table          # name -> np array

    def preprocessed(self, log_size: int):
        n = 1 << log_size
        out = []
        for key in ("pc", "opid", "opa", "opb", "opc", "imm_lo",
                    "imm_hi"):
            col = np.zeros(n, np.uint32)
            vals = self.table[key]
            col[:min(len(vals), n)] = vals[:n]
            out.append((f"pt_{key}", col))
        return out

    def evaluate(self, ctx):
        mult = ctx.main(0)
        ctx.add_fraction(-mult, "prog", [ctx.pre(i) for i in range(7)])


def decode_program_table(view) -> dict:
    """Decoded program columns from the public View (host, once)."""
    from ..vm.decoder import decode_instruction
    from ..vm.isa import InstrType
    pcs, opids, opas, opbs, opcs, imms = [], [], [], [], [], []
    for pc, word in view.program_info.program:
        ins = decode_instruction(int(word))
        opid = int(ins.opcode)
        opa, opb, opc, imm = ins.rd, ins.rs1, ins.rs2, ins.imm
        if ins.opcode == Opcode.ECALL:
            opa, opb, opc = 10, 17, 10
        if ins.itype not in (InstrType.R, InstrType.S, InstrType.B,
                             InstrType.CUSTOM):
            opc = 10 if ins.opcode == Opcode.ECALL else 0
        pcs.append(pc)
        opids.append(opid)
        opas.append(opa)
        opbs.append(opb)
        opcs.append(opc)
        imms.append(imm)
    imm = np.asarray(imms, np.uint64)
    return {
        "pc": np.asarray(pcs, np.uint32),
        "opid": np.asarray(opids, np.uint32),
        "opa": np.asarray(opas, np.uint32),
        "opb": np.asarray(opbs, np.uint32),
        "opc": np.asarray(opcs, np.uint32),
        "imm_lo": (imm & 0xFFFF).astype(np.uint32),
        "imm_hi": (imm >> 16).astype(np.uint32),
    }


# ---------------------------------------------------------------------------
# Vectorized fill
# ---------------------------------------------------------------------------


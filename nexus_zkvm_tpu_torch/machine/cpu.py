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
           "fill_cpu", "decode_program_table"]

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

_R_TYPE = {Opcode.ADD, Opcode.SUB, Opcode.SLL, Opcode.SLT, Opcode.SLTU,
           Opcode.XOR, Opcode.SRL, Opcode.SRA, Opcode.OR, Opcode.AND,
           Opcode.MUL, Opcode.MULH, Opcode.MULHSU, Opcode.MULHU,
           Opcode.DIV, Opcode.DIVU, Opcode.REM, Opcode.REMU,
           Opcode.KECCAKF, Opcode.PRECOMPILE}
_S_TYPE = {Opcode.SB, Opcode.SH, Opcode.SW}
_B_TYPE = {Opcode.BEQ, Opcode.BNE, Opcode.BLT, Opcode.BGE, Opcode.BLTU,
           Opcode.BGEU}
_IMM_C = {Opcode.ADDI, Opcode.SLLI, Opcode.SLTI, Opcode.SLTIU,
          Opcode.XORI, Opcode.SRLI, Opcode.SRAI, Opcode.ORI,
          Opcode.ANDI, Opcode.FENCE}
_LOADS = {Opcode.LB, Opcode.LH, Opcode.LW, Opcode.LBU, Opcode.LHU}
_CMP_OPS = _B_TYPE | {Opcode.SLT, Opcode.SLTU, Opcode.SLTI,
                      Opcode.SLTIU}
_SGN_OPS = _CMP_OPS | {Opcode.SRA, Opcode.SRAI, Opcode.LB, Opcode.LH}
_SLL_OPS = {Opcode.SLL, Opcode.SLLI}
_SRL_OPS = {Opcode.SRL, Opcode.SRLI}
_SRA_OPS = {Opcode.SRA, Opcode.SRAI}
_SHIFT_OPS = _SLL_OPS | _SRL_OPS | _SRA_OPS
_WRITE_OPS = (_R_TYPE | _IMM_C | _LOADS
              | {Opcode.JAL, Opcode.JALR, Opcode.LUI, Opcode.AUIPC}) \
              - {Opcode.FENCE}
_SYS_BY_CODE = {int(code): name for name, code in SYS_FLAGS}


def _bytes4(f, name, vals, rows=slice(None)):
    v = np.asarray(vals, np.uint64)
    for i in range(4):
        f[name][rows, i] = (v >> (8 * i)) & 0xFF


def _limbs(f, name, vals, rows=slice(None)):
    """8/8/8/6 limb split (value < 2^30)."""
    v = np.asarray(vals, np.uint64)
    assert np.all(v < (1 << 30)), f"{name} out of 2^30 range"
    for i in range(4):
        f[name][rows, i] = (v >> (8 * i)) & (0xFF if i < 3 else 0x3F)


def _inv_or_zero(vals):
    from ..ops.field import np_m31_inv
    v = np.asarray(vals, np.uint64)
    out = np.zeros_like(v)
    nzi = v != 0
    if nzi.any():
        out[nzi] = np_m31_inv(v[nzi])
    return out


def fill_cpu(trace, view, log_size: int, static_lo=None, static_hi=None):
    """(Trace, View) -> (filled column dict, table-emit index dict).

    Vectorized over all steps; the emit dict maps table-relation name
    to flat arrays of table-row indices for multiplicity counting.
    """
    from .tables import bitop_row_index
    s = trace.steps
    n = len(s["clk"])
    # trailing UNIMPL rows (k-block padding, ref `vm/src/trace.rs:
    # 218-247`) are equivalent to the power-of-two padding rows the
    # AIR already models -- strip them
    unimpl = s["opcode"] == int(Opcode.UNIMPL)
    if unimpl.any():
        assert unimpl[np.argmax(unimpl):].all(), \
            "UNIMPL steps must be a trailing block"
        n = int(np.argmax(unimpl))
        s = {k: v[:n] for k, v in s.items()}
    N = 1 << log_size
    assert n <= N and log_size <= 28
    opc = s["opcode"][:n]
    f = CPU_SCHEMA.alloc(N)
    R = slice(0, n)

    def sel(ops):
        if isinstance(ops, Opcode):
            return opc == int(ops)
        m = np.zeros(n, bool)
        for o in ops:
            m |= opc == int(o)
        return m

    present = set(np.unique(opc).tolist())
    supported = {int(o) for o in OP_FLAGS}
    assert present <= supported, \
        f"unsupported opcodes in trace: {present - supported}"

    # flags
    for op, i in _FLAG_IDX.items():
        f["f"][:n, i] = sel(op)
    is_ecall = sel(Opcode.ECALL)
    b_val = s["b_val"][:n].astype(np.uint64)
    for name, code in SYS_FLAGS:
        f[name][:n] = is_ecall & (b_val == int(code))
    s_halt = f["s_halt"][:n].astype(bool)
    f["pad"][n:] = 1

    # core scalars
    f["clk"][:n] = s["clk"][:n]
    _bytes4(f, "pc", s["pc"][:n], R)
    _bytes4(f, "npc", s["next_pc"][:n], R)
    _bytes4(f, "imm", s["imm"][:n], R)
    rd = s["rd"][:n].astype(np.uint32)
    rs1 = s["rs1"][:n].astype(np.uint32)
    rs2 = s["rs2"][:n].astype(np.uint32)
    f["opa"][:n] = np.where(is_ecall, 10, rd)
    f["opb"][:n] = rs1
    r_s_b = sel(_R_TYPE | _S_TYPE | _B_TYPE) | is_ecall
    f["opc"][:n] = np.where(r_s_b, rs2, 0)
    reg3 = np.where(is_ecall,
                    np.where(f["s_sp"][:n].astype(bool), 2, 10), rd)
    f["reg3"][:n] = reg3
    f["nz"][:n] = reg3 != 0
    f["inv_a"][:n] = _inv_or_zero(reg3)

    # values
    a_val = s["a_val"][:n].astype(np.uint64)
    c_val = s["c_val"][:n].astype(np.uint64)
    imm = s["imm"][:n].astype(np.uint64)
    writes = sel(_WRITE_OPS) | (is_ecall & (
        f["s_write"][:n] | f["s_priv"][:n] | f["s_sp"][:n]
        | f["s_hp"][:n]).astype(bool))
    uses_rs2 = r_s_b
    a_arr = np.where(writes, a_val, 0)
    c_arr = np.where(uses_rs2, c_val, np.where(sel(_IMM_C), imm, 0))
    _bytes4(f, "a", a_arr, R)
    _bytes4(f, "b", b_val, R)
    _bytes4(f, "c", c_arr, R)
    a_prev = np.where(writes, s["a_prev"][:n].astype(np.uint64), 0)
    f["a_prev_lo"][:n] = a_prev & 0xFFFF
    f["a_prev_hi"][:n] = a_prev >> 16

    # register timestamps
    clk = s["clk"][:n].astype(np.uint64)
    ts1p = s["ts1_prev"][:n].astype(np.uint64)
    f["ts1p"][:n] = ts1p
    _limbs(f, "tsd1", 3 * clk + 1 - ts1p - 1, R)
    ts2p = np.where(uses_rs2, s["ts2_prev"][:n].astype(np.uint64), 0)
    f["ts2p"][:n] = ts2p
    _limbs(f, "tsd2", np.where(uses_rs2, 3 * clk + 2 - ts2p - 1, 0), R)
    ts3p = np.where(writes, s["ts3_prev"][:n].astype(np.uint64), 0)
    f["ts3p"][:n] = ts3p
    _limbs(f, "tsd3", np.where(writes, 3 * clk + 3 - ts3p - 1, 0), R)

    # carries: ALU add/sub, jump links, auipc, and mem address
    b_lo, b_hi = b_val & 0xFFFF, b_val >> 16
    c_lo, c_hi = c_arr & 0xFFFF, c_arr >> 16
    pc = s["pc"][:n].astype(np.uint64)
    pc_lo, pc_hi = pc & 0xFFFF, pc >> 16
    imm_lo, imm_hi = imm & 0xFFFF, imm >> 16
    ca1 = np.zeros(n, np.uint64)
    ca2 = np.zeros(n, np.uint64)
    m = sel(Opcode.ADD) | sel(Opcode.ADDI)
    ca1[m] = (b_lo + c_lo)[m] >> 16
    ca2[m] = (b_hi + c_hi + ca1)[m] >> 16
    m = sel(Opcode.SUB)
    ca1[m] = (b_lo < c_lo)[m]
    ca2[m] = ((b_hi - c_hi - ca1) >> 63)[m] & 1
    m = sel(Opcode.JAL) | sel(Opcode.JALR)
    ca1[m] = (pc_lo + 4)[m] >> 16
    ca2[m] = 0
    m = sel(Opcode.AUIPC)
    ca1[m] = (pc_lo + imm_lo)[m] >> 16
    ca2[m] = (pc_hi + imm_hi + ca1)[m] >> 16
    is_load = sel(_LOADS)
    is_store = sel(_S_TYPE)
    ls = is_load | is_store
    maddr = np.where(s_halt, view.memory_layout.exit_code,
                     np.where(ls, s["mem_addr"][:n].astype(np.uint64)
                              & ~np.uint64(3), 0))
    raw_addr = np.where(ls, s["mem_addr"][:n].astype(np.uint64), maddr)
    _bytes4(f, "maddr", raw_addr, R)
    ca1[ls] = ((b_lo + imm_lo)[ls] >> 16)
    ca2[ls] = ((b_hi + imm_hi + ca1)[ls] >> 16) & 1
    f["carry_a"][:n, 0] = ca1
    f["carry_a"][:n, 1] = ca2

    # compare block
    cmp_on = sel(_CMP_OPS)
    br1 = np.zeros(n, np.uint64)
    br2 = np.zeros(n, np.uint64)
    h = np.zeros(n, np.uint64)
    br1[cmp_on] = (b_lo < c_lo)[cmp_on]
    h_lo = (b_lo - c_lo + (br1 << 16)) & 0xFFFF
    br2[cmp_on] = ((b_hi - c_hi - br1) >> 63)[cmp_on] & 1
    h_hi = (b_hi - c_hi - br1 + (br2 << 16)) & 0xFFFF
    h_lo = np.where(cmp_on, h_lo, 0)
    h_hi = np.where(cmp_on, h_hi, 0)
    f["br1"][:n] = br1
    f["br2"][:n] = br2
    f["h"][:n, 0] = h_lo & 0xFF
    f["h"][:n, 1] = h_lo >> 8
    f["h"][:n, 2] = h_hi & 0xFF
    f["h"][:n, 3] = h_hi >> 8
    # equality flags are globally constrained: e = (h == 0) on all rows
    e_lo_full = np.ones(N, np.uint64)
    e_hi_full = np.ones(N, np.uint64)
    e_lo_full[:n] = h_lo == 0
    e_hi_full[:n] = h_hi == 0
    f["e_lo"][:] = e_lo_full
    f["e_hi"][:] = e_hi_full
    f["i_lo"][:n] = _inv_or_zero(h_lo)
    f["i_hi"][:n] = _inv_or_zero(h_hi)
    sgn_on = sel(_SGN_OPS)
    b3 = (b_val >> 24) & 0xFF
    c3 = (c_arr >> 24) & 0xFF
    sgn_b = np.where(sgn_on, b3 >> 7, 0)
    sgn_c = np.where(cmp_on, c3 >> 7, 0)
    f["sgn_b"][:n] = sgn_b
    f["sgn_c"][:n] = sgn_c
    f["b3l7"][:n] = np.where(sgn_on, b3 & 0x7F, 0)
    f["c3l7"][:n] = np.where(cmp_on, c3 & 0x7F, 0)
    f["sgn_xor"][:n] = sgn_b ^ sgn_c

    # jalr lsb
    jalr = sel(Opcode.JALR)
    f["lsb"][:n] = np.where(jalr, (b_val + _sext_np(imm)) & 1, 0)

    # carry_pc from the committed npc (exact because limbs are canonical)
    npc = s["next_pc"][:n].astype(np.uint64)
    eq = (e_lo_full[:n] * e_hi_full[:n]).astype(np.uint64)
    lt_s = (br2 ^ (sgn_b ^ sgn_c)).astype(np.uint64)
    T = (sel(Opcode.BEQ) & (eq == 1)) | (sel(Opcode.BNE) & (eq == 0)) \
        | (sel(Opcode.BLT) & (lt_s == 1)) \
        | (sel(Opcode.BGE) & (lt_s == 0)) \
        | (sel(Opcode.BLTU) & (br2 == 1)) \
        | (sel(Opcode.BGEU) & (br2 == 0)) \
        | sel(Opcode.JAL) | jalr
    i64 = lambda x: np.asarray(x).astype(np.int64)
    base_lo = i64(np.where(jalr, b_lo, pc_lo))
    base_hi = i64(np.where(jalr, b_hi, pc_hi))
    lhs_lo = base_lo + i64(np.where(T, imm_lo, 0)) \
        + i64(np.where(T, 0, 4)) - i64(np.where(s_halt, 4, 0)) \
        - i64(f["lsb"][:n])
    cp1 = (lhs_lo - i64(npc & 0xFFFF)) >> 16
    lhs_hi = base_hi + i64(np.where(T, imm_hi, 0)) + cp1
    cp2 = (lhs_hi - i64(npc >> 16)) >> 16
    f["carry_pc"][:n, 0] = cp1
    f["carry_pc"][:n, 1] = cp2 & 1

    # shift block
    sll_on = sel(_SLL_OPS)
    shr_on = sel(_SRL_OPS | _SRA_OPS)
    sh_on = sll_on | shr_on
    c0 = c_arr & 0xFF
    f["c0q"][:n] = np.where(sh_on, c0 >> 5, 0)
    sh5 = np.where(sh_on, c0 & 31, 0)
    q_idx = sh5 >> 3
    r = sh5 & 7
    f["sh_r"][:n] = r
    for k in range(4):
        f["q"][:n, k] = sh_on & (q_idx == k)
    bb = [(b_val >> (8 * i)) & 0xFF for i in range(4)]
    for i in range(4):
        x = np.zeros(n, np.uint64)
        y = np.zeros(n, np.uint64)
        rem = np.zeros(n, np.uint64)
        # SLL: b_i * 2^r = x*256 + y
        prod = (bb[i] << r)
        x[sll_on] = (prod >> 8)[sll_on]
        y[sll_on] = (prod & 0xFF)[sll_on]
        # SRL/SRA: b_i = x * 2^r + rem ; y = rem * 2^(8-r)
        x[shr_on] = (bb[i] >> r)[shr_on]
        rem[shr_on] = (bb[i] - ((bb[i] >> r) << r))[shr_on]
        y[shr_on] = ((rem << (8 - r)) & 0xFF)[shr_on]
        f["sh_x"][:n, i] = x
        f["sh_y"][:n, i] = y
        f["sh_rem"][:n, i] = rem
    sra_on = sel(_SRA_OPS)
    f["sh_ph"][:n] = np.where(sra_on, (np.uint64(1) << (8 - r)) >> 8, 0)
    f["sh_p"][:n] = np.where(sra_on, (np.uint64(1) << (8 - r)) & 0xFF, 0)

    # memory block
    is_mem = ls | s_halt
    m0 = raw_addr & 0xFF
    mem_b = sel({Opcode.LB, Opcode.LBU, Opcode.SB})
    mem_h = sel({Opcode.LH, Opcode.LHU, Opcode.SH})
    f["mq"][:n] = np.where(is_mem, m0 >> 2, 0)
    ofs = m0 & 3
    f["mofs"][:n] = np.where(is_mem, ofs, 0)
    for i in range(4):
        f["l"][:n, i] = (mem_b & (ofs == i)) \
            | (mem_h & (i in (0, 2)) & (ofs == i))
    wp = np.where(is_mem, s["mem_prev_val"][:n].astype(np.uint64), 0)
    wn = np.where(is_mem, s["mem_new"][:n].astype(np.uint64), 0)
    _bytes4(f, "wp", wp, R)
    _bytes4(f, "wn", wn, R)
    mtsp = np.where(is_mem, s["mem_prev_ts"][:n].astype(np.uint64), 0)
    f["mtsp"][:n] = mtsp
    _limbs(f, "mtsd", np.where(is_mem, clk - mtsp - 1, 0), R)
    # load sign extraction
    lbh = sel({Opcode.LB, Opcode.LH})
    wp_bytes = [(wp >> (8 * i)) & 0xFF for i in range(4)]
    src_b = np.select([ofs == i for i in range(4)], wp_bytes, 0)
    src_h_hi = np.where(ofs == 2, wp_bytes[3], wp_bytes[1])
    sign_src = np.where(sel(Opcode.LB), src_b,
                        np.where(sel(Opcode.LH), src_h_hi, 0))
    f["ld_s"][:n] = np.where(lbh, sign_src >> 7, 0)
    f["ld_l7"][:n] = np.where(lbh, sign_src & 0x7F, 0)
    # region decompositions
    lay = view.memory_layout
    exit_addr = lay.exit_code
    heap = lay.heap_start
    st_lo = exit_addr if static_lo is None else static_lo
    st_hi = exit_addr if static_hi is None else static_hi
    srd = np.zeros(n, np.uint64)
    srd2 = np.zeros(n, np.uint64)
    st_sel = np.zeros(n, np.uint64)
    sm = (is_store | s_halt)
    above = raw_addr >= exit_addr
    st_sel[sm] = above[sm]
    srd[sm & above] = (raw_addr - exit_addr)[sm & above]
    # stores below exit_code must be in the static-RAM window
    in_static = sm & ~above
    srd[in_static] = (raw_addr - st_lo)[in_static]
    srd2[in_static] = (st_hi - 1 - raw_addr)[in_static]
    ls_sel = np.zeros(n, np.uint64)
    below = raw_addr < exit_addr
    ls_sel[is_load] = below[is_load]
    srd[is_load & below] = (exit_addr - 1 - raw_addr)[is_load & below]
    srd[is_load & ~below] = (raw_addr - heap)[is_load & ~below]
    f["ls_sel"][:n] = ls_sel
    f["st_sel"][:n] = st_sel
    _limbs(f, "srd", srd, R)
    _limbs(f, "srd2", srd2, R)

    # ---------------- table emit indices -----------------------------
    emits = {}

    def emit(rel, idx):
        emits.setdefault(rel, []).append(np.asarray(idx, np.int64))

    full = lambda name, i=0: (f[name][:, i] if f[name].ndim == 2
                              else f[name]).astype(np.int64)
    for name in ("a", "b", "c", "imm", "wp", "wn", "h"):
        for i in range(4):
            emit("r256", full(name, i))
    for name in ("pc", "npc", "maddr"):
        for i in range(3):
            emit("r256", full(name, i))
    for name in ("tsd1", "tsd2", "tsd3", "mtsd", "srd", "srd2"):
        for i in range(3):
            emit("r256", full(name, i))
    for name in ("pc", "npc", "maddr", "tsd1", "tsd2", "tsd3", "mtsd",
                 "srd", "srd2"):
        emit("r64", full(name, 3))
    emit("r64", full("mq"))
    for name in ("ld_l7", "b3l7", "c3l7"):
        emit("r128", full(name))
    emit("r8", f["c0q"][:n][sh_on].astype(np.int64))
    # bitwise tables (nibble pairs; hi + lo lookups per byte)
    and_or = sel({Opcode.AND, Opcode.ANDI, Opcode.OR, Opcode.ORI})
    xor_on = sel({Opcode.XOR, Opcode.XORI})
    bw_on = and_or | xor_on
    cb = [(c_arr >> (8 * i)) & 0xFF for i in range(4)]
    ab = [(a_arr >> (8 * i)) & 0xFF for i in range(4)]
    for i in range(4):
        f["bh"][:n, i] = np.where(bw_on, bb[i] >> 4, 0)
        f["ch"][:n, i] = np.where(bw_on, cb[i] >> 4, 0)
        f["ah"][:n, i] = np.where(bw_on, ab[i] >> 4, 0)
        for part in (lambda v: v >> 4, lambda v: v & 0xF):
            emit("and4", bitop_row_index(part(bb[i])[and_or],
                                         part(cb[i])[and_or]))
            emit("xor4", bitop_row_index(part(bb[i])[xor_on],
                                         part(cb[i])[xor_on]))
    # shift tables (row index = b * n_shamt + r)
    for i in range(4):
        emit("shl8", (bb[i][sll_on] * 9 + r[sll_on]))
        emit("shl8", (f["sh_rem"][:n, i][shr_on].astype(np.int64) * 9
                      + (8 - r[shr_on])))
        emit("shr8", (bb[i][shr_on] * 8 + r[shr_on]))
    emit("shl8", (np.full(int(sra_on.sum()), 1, np.int64) * 9
                  + (8 - r[sra_on])))

    emits = {k: np.concatenate(v) if v else np.zeros(0, np.int64)
             for k, v in emits.items()}
    return f, emits


def _sext_np(imm_u32):
    return imm_u32.astype(np.uint64)

"""RV32IM encoder — Instruction -> u32 word.

Counterpart of the reference encoder (`nexus-zkvm/common/src/riscv`
instruction builders).  Used by the synthetic-program assembler
(`vm/asm.py`) that replaces the reference's dependence on a RISC-V
cross toolchain for tests.
"""

from __future__ import annotations

from .decoder import Instruction
from .isa import Opcode, InstrType, ENCODING

__all__ = ["encode_instruction"]


def encode_instruction(ins: Instruction) -> int:
    opc = ins.opcode
    if opc == Opcode.ECALL:
        return 0x0000_0073
    if opc == Opcode.EBREAK:
        return 0x0010_0073
    if opc == Opcode.UNIMPL:
        return 0xC000_0073
    if opc == Opcode.PRECOMPILE:
        idx = ins.imm & 0x3FF
        return ((idx >> 3) << 25) | (ins.rs2 << 20) | (ins.rs1 << 15) \
            | ((idx & 7) << 12) | (ins.rd << 7) | 0x0B
    t, op7, f3, f7 = ENCODING[opc]
    imm = ins.imm & 0xFFFF_FFFF
    if t in (InstrType.R, InstrType.CUSTOM):
        return (f7 << 25) | (ins.rs2 << 20) | (ins.rs1 << 15) | (f3 << 12) \
            | (ins.rd << 7) | op7
    if t == InstrType.I:
        if opc in (Opcode.SLLI, Opcode.SRLI, Opcode.SRAI):
            hi = (f7 << 5) | (imm & 0x1F)
        else:
            hi = imm & 0xFFF
        return (hi << 20) | (ins.rs1 << 15) | (f3 << 12) | (ins.rd << 7) \
            | op7
    if t == InstrType.S:
        return ((imm >> 5 & 0x7F) << 25) | (ins.rs2 << 20) \
            | (ins.rs1 << 15) | (f3 << 12) | ((imm & 0x1F) << 7) | op7
    if t == InstrType.B:
        return ((imm >> 12 & 1) << 31) | ((imm >> 5 & 0x3F) << 25) \
            | (ins.rs2 << 20) | (ins.rs1 << 15) | (f3 << 12) \
            | ((imm >> 1 & 0xF) << 8) | ((imm >> 11 & 1) << 7) | op7
    if t == InstrType.U:
        return (imm & 0xFFFF_F000) | (ins.rd << 7) | op7
    if t == InstrType.J:
        return ((imm >> 20 & 1) << 31) | ((imm >> 1 & 0x3FF) << 21) \
            | ((imm >> 11 & 1) << 20) | ((imm >> 12 & 0xFF) << 12) \
            | (ins.rd << 7) | op7
    raise ValueError(f"cannot encode {opc!r}")

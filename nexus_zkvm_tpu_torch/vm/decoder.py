"""RV32IM decoder: raw u32 words -> instructions and basic blocks.

Counterpart of the reference decoder
(`nexus-zkvm/vm/src/riscv/decoder.rs:1-50`, basic blocks at
`vm/src/riscv/instructions/basic_block.rs`).  Besides the scalar
decode used by the emulator, :func:`decode_program` decodes a whole
code image **vectorized** (numpy over all words at once) for the
program-trace columns the prover commits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .isa import (
    Opcode, InstrType, ENCODING, BY_ENCODING, BLOCK_END_OPS,
    KECCAKF_OPCODE,
)

__all__ = ["Instruction", "decode_instruction", "decode_program",
           "split_basic_blocks"]


@dataclass(frozen=True)
class Instruction:
    """One decoded instruction.

    ``rd``/``rs1``/``rs2`` follow hardware roles; ``imm`` is the
    sign-extended immediate as an unsigned 32-bit value.  For U/J types
    ``imm`` holds the full shifted immediate.
    """
    opcode: Opcode
    itype: InstrType
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0            # u32 (two's complement for negatives)
    word: int = 0x0000_0013  # raw encoding (default: nop)

    def ends_block(self) -> bool:
        return self.opcode in BLOCK_END_OPS


NOP = Instruction(opcode=Opcode.ADDI, itype=InstrType.I, rd=0, rs1=0,
                  imm=0, word=0x13)
UNIMPL = Instruction(opcode=Opcode.UNIMPL, itype=InstrType.UNIMPL,
                     word=0xC000_0073)


def _sext(value: int, bits: int) -> int:
    """Sign-extend the low `bits` of value to u32."""
    m = 1 << (bits - 1)
    v = value & ((1 << bits) - 1)
    return ((v ^ m) - m) & 0xFFFF_FFFF


def decode_instruction(word: int) -> Instruction:
    word &= 0xFFFF_FFFF
    op7 = word & 0x7F
    rd = (word >> 7) & 0x1F
    f3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f7 = (word >> 25) & 0x7F

    if op7 == 0x73:  # SYSTEM
        if f3 == 0:
            body = word >> 7
            if body == 0:
                # ecall reads the syscall number from a7 and its operand
                # from a0 — modelled as rs1=x17, rs2=x10 so the register
                # access slots line up with the machine AIR
                return Instruction(Opcode.ECALL, InstrType.SYS, rs1=17,
                                   rs2=10, word=word)
            if body == (1 << 13):
                return Instruction(Opcode.EBREAK, InstrType.SYS, word=word)
        return Instruction(Opcode.UNIMPL, InstrType.UNIMPL, word=word)
    if op7 == (KECCAKF_OPCODE & 0x7F):
        return Instruction(Opcode.KECCAKF, InstrType.CUSTOM, rd=rd,
                           rs1=rs1, rs2=rs2, word=word)
    if op7 == 0x0B:  # custom-0: dynamic precompile, index in f7*8+f3
        return Instruction(Opcode.PRECOMPILE, InstrType.CUSTOM, rd=rd,
                           rs1=rs1, rs2=rs2, imm=(f7 << 3) | f3,
                           word=word)
    if op7 == 0x2B and f3 == 0:   # `rin` == lw (ref registry.rs:232,274)
        return Instruction(Opcode.LW, InstrType.I, rd=rd, rs1=rs1,
                           imm=_sext(word >> 20, 12), word=word)
    if op7 == 0x5B and f3 == 0:   # `wou` == sw (ref registry.rs:233,287)
        return Instruction(Opcode.SW, InstrType.S, rs1=rs1, rs2=rs2,
                           imm=_sext((f7 << 5) | rd, 12), word=word)

    for key in ((op7, f3, f7), (op7, f3, None), (op7, None, None)):
        opc = BY_ENCODING.get(key)
        if opc is not None:
            break
    else:
        return Instruction(Opcode.UNIMPL, InstrType.UNIMPL, word=word)

    t = ENCODING[opc][0]
    if t == InstrType.R:
        return Instruction(opc, t, rd=rd, rs1=rs1, rs2=rs2, word=word)
    if t == InstrType.I:
        if opc in (Opcode.SLLI, Opcode.SRLI, Opcode.SRAI):
            imm = rs2  # shamt
        else:
            imm = _sext(word >> 20, 12)
        return Instruction(opc, t, rd=rd, rs1=rs1, imm=imm, word=word)
    if t == InstrType.S:
        imm = _sext((f7 << 5) | rd, 12)
        return Instruction(opc, t, rs1=rs1, rs2=rs2, imm=imm, word=word)
    if t == InstrType.B:
        imm = _sext(((word >> 31) << 12) | (((word >> 7) & 1) << 11)
                    | (((word >> 25) & 0x3F) << 5)
                    | (((word >> 8) & 0xF) << 1), 13)
        return Instruction(opc, t, rs1=rs1, rs2=rs2, imm=imm, word=word)
    if t == InstrType.U:
        return Instruction(opc, t, rd=rd, imm=word & 0xFFFF_F000, word=word)
    if t == InstrType.J:
        imm = _sext(((word >> 31) << 20) | (((word >> 12) & 0xFF) << 12)
                    | (((word >> 20) & 1) << 11)
                    | (((word >> 21) & 0x3FF) << 1), 21)
        return Instruction(opc, t, rd=rd, imm=imm, word=word)
    return Instruction(Opcode.UNIMPL, InstrType.UNIMPL, word=word)


def decode_program(words: np.ndarray) -> list:
    """Decode a full code image. Returns a list of Instructions."""
    return [decode_instruction(int(w)) for w in np.asarray(words)]


def split_basic_blocks(instructions) -> list:
    """Split a decoded instruction list into single-exit basic blocks."""
    blocks, cur = [], []
    for ins in instructions:
        cur.append(ins)
        if ins.ends_block():
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks

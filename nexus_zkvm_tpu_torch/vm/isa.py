"""RV32IM instruction-set vocabulary: opcodes, registers, encodings.

Counterpart of the reference `common/` crate
(`nexus-zkvm/common/src/riscv/opcode.rs:280-350`,
`registers.rs`, and `constants/mod.rs:1-15`).  The ``Opcode`` numbering
follows the reference's ``BuiltinOpcode`` variant order so one-hot flag
columns and golden traces are comparable across implementations.
"""

from __future__ import annotations

import enum

__all__ = [
    "Opcode", "Register", "InstrType", "ENCODING", "BY_ENCODING",
    "WORD_SIZE", "NUM_REGISTERS", "MEMORY_TOP", "ELF_TEXT_START",
    "PUBLIC_INPUT_ADDRESS_LOCATION", "PUBLIC_OUTPUT_ADDRESS_LOCATION",
    "KECCAKF_OPCODE", "SyscallCode",
]

WORD_SIZE = 4
NUM_REGISTERS = 32
MEMORY_TOP = 0x8040_0000
PUBLIC_INPUT_ADDRESS_LOCATION = NUM_REGISTERS * WORD_SIZE        # 0x80
PUBLIC_OUTPUT_ADDRESS_LOCATION = PUBLIC_INPUT_ADDRESS_LOCATION + WORD_SIZE
ELF_TEXT_START = PUBLIC_OUTPUT_ADDRESS_LOCATION + WORD_SIZE      # 0x88
KECCAKF_OPCODE = 0x5A


class Opcode(enum.IntEnum):
    """RV32IM builtin opcodes, reference variant order."""
    ADD = 0; SUB = 1; SLL = 2; SLT = 3; SLTU = 4; XOR = 5; SRL = 6
    SRA = 7; OR = 8; AND = 9
    MUL = 10; MULH = 11; MULHSU = 12; MULHU = 13; DIV = 14; DIVU = 15
    REM = 16; REMU = 17
    ADDI = 18; SLLI = 19; SLTI = 20; SLTIU = 21; XORI = 22; SRLI = 23
    SRAI = 24; ORI = 25; ANDI = 26
    LB = 27; LH = 28; LW = 29; LBU = 30; LHU = 31
    JALR = 32; ECALL = 33; EBREAK = 34; FENCE = 35
    SB = 36; SH = 37; SW = 38
    BEQ = 39; BNE = 40; BLT = 41; BGE = 42; BLTU = 43; BGEU = 44
    LUI = 45; AUIPC = 46
    JAL = 47
    UNIMPL = 48
    # custom instruction space (not part of the reference enum numbering)
    KECCAKF = 64
    PRECOMPILE = 65     # dynamic precompile; index in Instruction.imm

    @property
    def mnemonic(self) -> str:
        return self.name.lower()


class Register(enum.IntEnum):
    X0 = 0; X1 = 1; X2 = 2; X3 = 3; X4 = 4; X5 = 5; X6 = 6; X7 = 7
    X8 = 8; X9 = 9; X10 = 10; X11 = 11; X12 = 12; X13 = 13; X14 = 14
    X15 = 15; X16 = 16; X17 = 17; X18 = 18; X19 = 19; X20 = 20; X21 = 21
    X22 = 22; X23 = 23; X24 = 24; X25 = 25; X26 = 26; X27 = 27; X28 = 28
    X29 = 29; X30 = 30; X31 = 31


# ABI aliases
ABI = {"zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4, "t0": 5, "t1": 6,
       "t2": 7, "s0": 8, "fp": 8, "s1": 9, "a0": 10, "a1": 11, "a2": 12,
       "a3": 13, "a4": 14, "a5": 15, "a6": 16, "a7": 17, "s2": 18,
       "s3": 19, "s4": 20, "s5": 21, "s6": 22, "s7": 23, "s8": 24,
       "s9": 25, "s10": 26, "s11": 27, "t3": 28, "t4": 29, "t5": 30,
       "t6": 31}


class InstrType(enum.IntEnum):
    R = 0
    I = 1        # noqa: E741
    S = 2
    B = 3
    U = 4
    J = 5
    SYS = 6
    UNIMPL = 7
    CUSTOM = 8


class SyscallCode(enum.IntEnum):
    """a7 codes dispatched by ECALL
    (`nexus-zkvm/vm/src/system/syscall.rs:41-53`)."""
    WRITE = 0x200
    EXIT = 0x201
    READ_PRIVATE_INPUT = 0x400
    CYCLE_COUNT = 0x401
    OVERWRITE_STACK_POINTER = 0x402
    OVERWRITE_HEAP_POINTER = 0x403
    MEMORY_ADVISE = 0x405


# opcode7 field values
_OP = 0x33
_OP_IMM = 0x13
_LOAD = 0x03
_STORE = 0x23
_BRANCH = 0x63
_LUI = 0x37
_AUIPC = 0x17
_JAL = 0x6F
_JALR = 0x67
_SYSTEM = 0x73
_FENCE = 0x0F

# Opcode -> (type, opcode7, funct3, funct7); funct3/funct7 None = n/a.
ENCODING = {
    Opcode.ADD:    (InstrType.R, _OP, 0b000, 0b0000000),
    Opcode.SUB:    (InstrType.R, _OP, 0b000, 0b0100000),
    Opcode.SLL:    (InstrType.R, _OP, 0b001, 0b0000000),
    Opcode.SLT:    (InstrType.R, _OP, 0b010, 0b0000000),
    Opcode.SLTU:   (InstrType.R, _OP, 0b011, 0b0000000),
    Opcode.XOR:    (InstrType.R, _OP, 0b100, 0b0000000),
    Opcode.SRL:    (InstrType.R, _OP, 0b101, 0b0000000),
    Opcode.SRA:    (InstrType.R, _OP, 0b101, 0b0100000),
    Opcode.OR:     (InstrType.R, _OP, 0b110, 0b0000000),
    Opcode.AND:    (InstrType.R, _OP, 0b111, 0b0000000),
    Opcode.MUL:    (InstrType.R, _OP, 0b000, 0b0000001),
    Opcode.MULH:   (InstrType.R, _OP, 0b001, 0b0000001),
    Opcode.MULHSU: (InstrType.R, _OP, 0b010, 0b0000001),
    Opcode.MULHU:  (InstrType.R, _OP, 0b011, 0b0000001),
    Opcode.DIV:    (InstrType.R, _OP, 0b100, 0b0000001),
    Opcode.DIVU:   (InstrType.R, _OP, 0b101, 0b0000001),
    Opcode.REM:    (InstrType.R, _OP, 0b110, 0b0000001),
    Opcode.REMU:   (InstrType.R, _OP, 0b111, 0b0000001),
    Opcode.ADDI:   (InstrType.I, _OP_IMM, 0b000, None),
    Opcode.SLLI:   (InstrType.I, _OP_IMM, 0b001, 0b0000000),
    Opcode.SLTI:   (InstrType.I, _OP_IMM, 0b010, None),
    Opcode.SLTIU:  (InstrType.I, _OP_IMM, 0b011, None),
    Opcode.XORI:   (InstrType.I, _OP_IMM, 0b100, None),
    Opcode.SRLI:   (InstrType.I, _OP_IMM, 0b101, 0b0000000),
    Opcode.SRAI:   (InstrType.I, _OP_IMM, 0b101, 0b0100000),
    Opcode.ORI:    (InstrType.I, _OP_IMM, 0b110, None),
    Opcode.ANDI:   (InstrType.I, _OP_IMM, 0b111, None),
    Opcode.LB:     (InstrType.I, _LOAD, 0b000, None),
    Opcode.LH:     (InstrType.I, _LOAD, 0b001, None),
    Opcode.LW:     (InstrType.I, _LOAD, 0b010, None),
    Opcode.LBU:    (InstrType.I, _LOAD, 0b100, None),
    Opcode.LHU:    (InstrType.I, _LOAD, 0b101, None),
    Opcode.JALR:   (InstrType.I, _JALR, 0b000, None),
    Opcode.ECALL:  (InstrType.SYS, _SYSTEM, 0b000, 0b0000000),
    Opcode.EBREAK: (InstrType.SYS, _SYSTEM, 0b000, 0b0000000),
    Opcode.FENCE:  (InstrType.I, _FENCE, 0b000, None),
    Opcode.SB:     (InstrType.S, _STORE, 0b000, None),
    Opcode.SH:     (InstrType.S, _STORE, 0b001, None),
    Opcode.SW:     (InstrType.S, _STORE, 0b010, None),
    Opcode.BEQ:    (InstrType.B, _BRANCH, 0b000, None),
    Opcode.BNE:    (InstrType.B, _BRANCH, 0b001, None),
    Opcode.BLT:    (InstrType.B, _BRANCH, 0b100, None),
    Opcode.BGE:    (InstrType.B, _BRANCH, 0b101, None),
    Opcode.BLTU:   (InstrType.B, _BRANCH, 0b110, None),
    Opcode.BGEU:   (InstrType.B, _BRANCH, 0b111, None),
    Opcode.LUI:    (InstrType.U, _LUI, None, None),
    Opcode.AUIPC:  (InstrType.U, _AUIPC, None, None),
    Opcode.JAL:    (InstrType.J, _JAL, None, None),
    Opcode.KECCAKF: (InstrType.CUSTOM, KECCAKF_OPCODE & 0x7F, 0b000,
                     0b0000000),
}

# (opcode7, funct3, funct7-or-None) -> Opcode, for the decoder.
BY_ENCODING = {}
for _opc, (_t, _o7, _f3, _f7) in ENCODING.items():
    if _opc in (Opcode.ECALL, Opcode.EBREAK):
        continue
    BY_ENCODING[(_o7, _f3, _f7)] = _opc

BRANCH_OPS = frozenset({Opcode.BEQ, Opcode.BNE, Opcode.BLT, Opcode.BGE,
                        Opcode.BLTU, Opcode.BGEU})
JUMP_OPS = frozenset({Opcode.JAL, Opcode.JALR})
LOAD_OPS = frozenset({Opcode.LB, Opcode.LH, Opcode.LW, Opcode.LBU,
                      Opcode.LHU})
STORE_OPS = frozenset({Opcode.SB, Opcode.SH, Opcode.SW})
# ops that terminate a basic block (single-entry/single-exit decode,
# `nexus-zkvm/vm/src/riscv/decoder.rs`)
BLOCK_END_OPS = BRANCH_OPS | JUMP_OPS | {Opcode.ECALL, Opcode.EBREAK,
                                         Opcode.UNIMPL}

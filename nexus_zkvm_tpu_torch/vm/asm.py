"""A tiny RV32IM assembler for synthetic guest programs.

The reference builds its test guests with a RISC-V Rust cross
toolchain (`nexus-zkvm/common-testing/src/emulator.rs:19-80`);
this environment has none, so tests and examples assemble programs
directly.  Supports labels, the full RV32IM mnemonic set, and a few
pseudo-instructions (``li``, ``mv``, ``nop``, ``j``, ``ret``).

Example::

    words = assemble('''
        addi a0, zero, 10
    loop:
        addi a0, a0, -1
        bne  a0, zero, loop
        addi a7, zero, 0x201   # Exit
        ecall
    ''')
"""

from __future__ import annotations

from .decoder import Instruction
from .encoder import encode_instruction
from .isa import Opcode, InstrType, ENCODING, ABI

__all__ = ["assemble", "assemble_instructions"]


def _reg(tok: str) -> int:
    tok = tok.strip().lower()
    if tok in ABI:
        return ABI[tok]
    if tok.startswith("x"):
        return int(tok[1:])
    raise ValueError(f"bad register {tok!r}")


def _int(tok: str) -> int:
    return int(tok.strip(), 0)


def _parse_mem(tok: str):
    """'imm(reg)' -> (imm, reg)."""
    off, rest = tok.split("(", 1)
    return _int(off or "0"), _reg(rest.rstrip(")"))


def _split_imm(val: int):
    """val -> (hi, lo_s) with val = hi + lo_s (lui/addi split)."""
    val &= 0xFFFF_FFFF
    lo = val & 0xFFF
    lo_s = lo - 0x1000 if lo >= 0x800 else lo
    hi = (val - lo_s) & 0xFFFF_FFFF
    return hi, lo_s


def _line_words(mn: str, args: list) -> int:
    """Words a source line expands to (pass 1 must know, or labels
    after a multi-word pseudo-instruction would shift)."""
    if mn == "li":
        hi, lo_s = _split_imm(_int(args[1]))
        return 2 if (hi and lo_s) else 1
    if mn == "la":
        return 2          # always lui+addi (label may be forward)
    if mn == ".word":
        return len(args)
    return 1


def assemble_instructions(source: str, base: int = 0) -> list:
    """Assemble to a list of Instruction (two-pass for labels)."""
    lines = []
    labels = {}
    pc = base
    for raw in source.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        while ":" in line:
            label, line = line.split(":", 1)
            labels[label.strip()] = pc
            line = line.strip()
        if line:
            parts = line.replace(",", " ").split()
            lines.append((pc, line))
            pc += 4 * _line_words(parts[0].lower(), parts[1:])

    out = []
    for pc, line in lines:
        parts = line.replace(",", " ").split()
        mn, args = parts[0].lower(), parts[1:]

        def target(tok):
            if tok in labels:
                return (labels[tok] - pc) & 0xFFFF_FFFF
            return _int(tok) & 0xFFFF_FFFF

        # pseudo-instructions
        if mn == "nop":
            mn, args = "addi", ["x0", "x0", "0"]
        elif mn == "mv":
            mn, args = "addi", [args[0], args[1], "0"]
        elif mn in ("li", "la"):
            if mn == "la":
                val = labels[args[1]] & 0xFFFF_FFFF
            else:
                val = _int(args[1]) & 0xFFFF_FFFF
            hi, lo_s = _split_imm(val)
            if hi or mn == "la":
                out.append(Instruction(Opcode.LUI, InstrType.U,
                                       rd=_reg(args[0]), imm=hi))
                if lo_s or mn == "la":
                    out.append(Instruction(
                        Opcode.ADDI, InstrType.I, rd=_reg(args[0]),
                        rs1=_reg(args[0]), imm=lo_s & 0xFFFF_FFFF))
            else:
                out.append(Instruction(Opcode.ADDI, InstrType.I,
                                       rd=_reg(args[0]), rs1=0,
                                       imm=lo_s & 0xFFFF_FFFF))
            continue
        elif mn == ".word":
            for tok in args:
                out.append(_RawWord(_int(tok) & 0xFFFF_FFFF))
            continue
        elif mn == "j":
            mn, args = "jal", ["x0", args[0]]
        elif mn == "call":
            mn, args = "jal", ["ra", args[0]]
        elif mn == "beqz":
            mn, args = "beq", [args[0], "x0", args[1]]
        elif mn == "bnez":
            mn, args = "bne", [args[0], "x0", args[1]]
        elif mn == "ret":
            mn, args = "jalr", ["x0", "0(ra)"]

        if mn == "precompile":
            # precompile IDX, rd, rs1, rs2
            out.append(Instruction(Opcode.PRECOMPILE, InstrType.CUSTOM,
                                   rd=_reg(args[1]), rs1=_reg(args[2]),
                                   rs2=_reg(args[3]),
                                   imm=_int(args[0]) & 0x3FF))
            continue

        opc = Opcode[mn.upper()]
        t = ENCODING[opc][0]
        if t == InstrType.R or t == InstrType.CUSTOM:
            ins = Instruction(opc, t, rd=_reg(args[0]), rs1=_reg(args[1]),
                              rs2=_reg(args[2]))
        elif t == InstrType.I:
            if opc in (Opcode.LB, Opcode.LH, Opcode.LW, Opcode.LBU,
                       Opcode.LHU):
                imm, rs1 = _parse_mem(args[1])
                ins = Instruction(opc, t, rd=_reg(args[0]), rs1=rs1,
                                  imm=imm & 0xFFFF_FFFF)
            elif opc == Opcode.JALR:
                if "(" in args[-1]:
                    imm, rs1 = _parse_mem(args[1])
                else:
                    rs1, imm = _reg(args[1]), _int(args[2])
                ins = Instruction(opc, t, rd=_reg(args[0]), rs1=rs1,
                                  imm=imm & 0xFFFF_FFFF)
            elif opc == Opcode.FENCE:
                ins = Instruction(opc, t)
            else:
                ins = Instruction(opc, t, rd=_reg(args[0]),
                                  rs1=_reg(args[1]),
                                  imm=_int(args[2]) & 0xFFFF_FFFF)
        elif t == InstrType.S:
            imm, rs1 = _parse_mem(args[1])
            ins = Instruction(opc, t, rs1=rs1, rs2=_reg(args[0]),
                              imm=imm & 0xFFFF_FFFF)
        elif t == InstrType.B:
            ins = Instruction(opc, t, rs1=_reg(args[0]), rs2=_reg(args[1]),
                              imm=target(args[2]))
        elif t == InstrType.U:
            ins = Instruction(opc, t, rd=_reg(args[0]),
                              imm=(_int(args[1]) << 12) & 0xFFFF_FFFF
                              if not args[1].startswith("0x")
                              else _int(args[1]) & 0xFFFF_F000)
        elif t == InstrType.J:
            ins = Instruction(opc, t, rd=_reg(args[0]), imm=target(args[1]))
        elif t == InstrType.SYS:
            ins = Instruction(opc, t)
        else:
            raise ValueError(f"cannot assemble {mn}")
        out.append(ins)

    final = []
    for i in out:
        if isinstance(i, _RawWord):
            final.append(i)
        else:
            final.append(Instruction(i.opcode, i.itype, i.rd, i.rs1,
                                     i.rs2, i.imm,
                                     encode_instruction(i)))
    return final


class _RawWord:
    """A literal data word emitted by the ``.word`` directive."""
    __slots__ = ("word",)

    def __init__(self, word: int):
        self.word = word


def assemble(source: str, base: int = 0) -> list:
    """Assemble to a list of u32 words."""
    return [i.word if isinstance(i, _RawWord) else encode_instruction(i)
            for i in assemble_instructions(source, base)]

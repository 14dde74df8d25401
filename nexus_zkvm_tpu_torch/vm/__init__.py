"""Host-side RV32IM virtual machine: decode, emulate, trace.

Counterpart of the reference `vm/` crate (`nexus-zkvm/vm/src/`):
ELF loading, two-pass emulation (Harvard discovery pass + Linear
trace pass), syscall handling, and execution-trace generation.

TPU-first design difference: the trace is **struct-of-arrays** numpy
(one array per field over all steps), not a vector of step structs —
the machine AIR consumes it with vectorized column fills and sort/scan
memory-check derivations instead of the reference's row-by-row
SideNote loop (`nexus-zkvm/prover/src/machine.rs:163-171`).
"""

from .isa import Opcode, Register, InstrType
from .decoder import decode_instruction, decode_program
from .encoder import encode_instruction
from . import asm
from .memory import LinearMemoryLayout
from .trace import k_trace, k_trace_direct, bb_trace, Trace, View
from .elf import ElfFile

__all__ = [
    "Opcode", "Register", "InstrType", "decode_instruction",
    "decode_program", "encode_instruction", "asm", "LinearMemoryLayout",
    "k_trace", "k_trace_direct", "bb_trace", "Trace", "View", "ElfFile",
]

"""The fib guest's public claim on n, built here and not taken from the
prover: the memory layout and the initial image by the emulator's
layout rule, the program as the frozen assembler makes it, the input n
as one little-endian word, fib(n) mod 2^32 as the first word of the
public output (the rest of the output region zero), exit code 0.

The layout rule (the emulator's ``LinearEmulator.from_harvard``, after
the reference's ``MemoryStats::create_optimized_layout``): the program
region holds the program and 0x1000 bytes more, the public input its
bytes and a length word, the output 0x200 bytes, the heap the guest's
heap use and 0x1000 bytes more but at least 0x10000, the stack 0x100000
bytes; the fib guest touches no heap.  The initial image is the input
tape (length word, then bytes) at the input region's start and the two
IO pointers at 0x80 and 0x84; the guest has no static data.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, fields

from .nzt.vm.isa import (ELF_TEXT_START, PUBLIC_INPUT_ADDRESS_LOCATION,
                         PUBLIC_OUTPUT_ADDRESS_LOCATION, WORD_SIZE)

__all__ = ["fib_u32", "public_input", "Layout", "layout", "claim",
           "claim_errors"]

OUTPUT_BYTES = 0x200
STACK_BYTES = 0x10_0000
HEAP_BYTES = 0x1_0000          # max(heap use 0 + 0x1000, 0x10000)


def fib_u32(n: int) -> int:
    """fib(n) mod 2^32 by fast doubling: F(2k) = F(k)(2F(k+1) - F(k)),
    F(2k+1) = F(k)^2 + F(k+1)^2."""
    m = 1 << 32
    a, b = 0, 1
    for bit in bin(int(n))[2:]:
        a, b = (a * ((2 * b - a) % m)) % m, (a * a + b * b) % m
        if bit == "1":
            a, b = b, (a + b) % m
    return a


def public_input(n: int) -> bytes:
    return struct.pack("<I", int(n) & 0xFFFFFFFF)


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


@dataclass
class Layout:
    """The region boundaries, with the accessors the verifier reads."""
    public_input: int
    exit_code: int
    public_output: int
    heap: int
    stack_bottom: int
    stack_top: int
    end: int
    static_ram: tuple | None = None

    program_start = ELF_TEXT_START
    public_input_address_location = PUBLIC_INPUT_ADDRESS_LOCATION
    public_output_address_location = PUBLIC_OUTPUT_ADDRESS_LOCATION

    @property
    def program_end(self):
        return self.public_input

    @property
    def public_input_start(self):
        return self.public_input

    @property
    def public_output_start(self):
        return self.public_output

    @property
    def public_output_end(self):
        return self.heap

    @property
    def heap_start(self):
        return self.heap


def layout(program_words: int, input_bytes: int) -> Layout:
    public_in = ELF_TEXT_START + _align(4 * program_words + 0x1000,
                                        WORD_SIZE)
    exit_code = _align(public_in + input_bytes + WORD_SIZE, WORD_SIZE)
    public_out = exit_code + WORD_SIZE
    heap = _align(public_out + OUTPUT_BYTES, WORD_SIZE)
    stack_bottom = _align(heap + HEAP_BYTES, WORD_SIZE)
    stack_top = _align(stack_bottom + STACK_BYTES, 16)
    return Layout(public_input=public_in, exit_code=exit_code,
                  public_output=public_out, heap=heap,
                  stack_bottom=stack_bottom, stack_top=stack_top,
                  end=stack_top)


@dataclass
class ProgramInfo:
    initial_pc: int
    program: list


@dataclass
class View:
    """The public claim, with the fields the frozen verifier reads."""
    memory_layout: Layout
    program_info: ProgramInfo
    public_input: bytes
    exit_code: int
    public_output: bytes
    associated_data: bytes
    initial_memory: list = field(default_factory=list)


def claim(n: int, program: list) -> View:
    """The fib guest's public claim on n, ``program`` its words."""
    inp = public_input(n)
    lay = layout(len(program), len(inp))
    tape = len(inp).to_bytes(4, "little") + inp
    image = [(lay.public_input_start + i, b) for i, b in enumerate(tape)]
    pointers = (struct.pack("<I", lay.public_input_start)
                + struct.pack("<I", lay.public_output_start))
    image += [(PUBLIC_INPUT_ADDRESS_LOCATION + i, b)
              for i, b in enumerate(pointers)]
    out = struct.pack("<I", fib_u32(n)).ljust(OUTPUT_BYTES, b"\0")
    return View(memory_layout=lay,
                program_info=ProgramInfo(
                    initial_pc=ELF_TEXT_START,
                    program=[(ELF_TEXT_START + 4 * i, int(w))
                             for i, w in enumerate(program)]),
                public_input=inp, exit_code=0, public_output=out,
                associated_data=b"", initial_memory=image)


def claim_errors(view, want: View) -> list:
    """What differs between a proof's public View and the reference's
    claim ``want``: [] when nothing does."""
    out = []
    got_lay = view.memory_layout
    if any(getattr(got_lay, f.name) != getattr(want.memory_layout, f.name)
           for f in fields(Layout)):
        out.append("memory layout")
    if [(int(a), int(b)) for a, b in view.initial_memory] != \
            want.initial_memory:
        out.append("initial memory")
    if bytes(view.public_input) != want.public_input:
        out.append("public input")
    if bytes(view.public_output) != want.public_output:
        out.append("public output")
    if view.exit_code != want.exit_code:
        out.append("exit code")
    if bytes(view.associated_data) != want.associated_data:
        out.append("associated data")
    info = view.program_info
    if [(int(pc), int(w)) for pc, w in info.program] != \
            want.program_info.program or \
            info.initial_pc != want.program_info.initial_pc:
        out.append("program")
    return out

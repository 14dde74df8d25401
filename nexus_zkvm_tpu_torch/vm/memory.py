"""Memory layout and the linear memory of the trace pass.

Counterpart of the reference layout
(`nexus-zkvm/vm/src/emulator/layout.rs:117-230`) and unified
memory (`vm/src/memory/unified.rs:85-360`).  Layout ordering (all
addresses virtual, word-aligned):

  registers | IO sentinels | program+static | public input (len-prefixed)
  | exit code | public output | heap | stack | associated data

The trace-pass memory is a single flat ``bytearray`` spanning
[0, end) with a per-segment mode map (RO / RW / WO / NA), which keeps
byte loads O(1) and lets the final RAM image be exported as one numpy
array for the prover's RAM init/final component.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from .isa import (
    WORD_SIZE, ELF_TEXT_START, PUBLIC_INPUT_ADDRESS_LOCATION,
    PUBLIC_OUTPUT_ADDRESS_LOCATION, NUM_REGISTERS,
)

__all__ = ["LinearMemoryLayout", "LinearMemory", "MemoryError_",
           "RO", "RW", "WO", "NA"]

RO, RW, WO, NA = "RO", "RW", "WO", "NA"


class MemoryError_(Exception):
    pass


def _word_align(x: int) -> int:
    return (x + WORD_SIZE - 1) & ~(WORD_SIZE - 1)


def _align16(x: int) -> int:
    return (x + 15) & ~15


@dataclass(frozen=True)
class LinearMemoryLayout:
    """Validated region boundaries (reference `layout.rs:117-157`)."""
    public_input: int
    exit_code: int
    public_output: int
    heap: int
    stack_bottom: int
    stack_top: int
    end: int
    static_ram: tuple | None = None

    @staticmethod
    def new(max_heap_size=0x80_0000, max_stack_size=0x10_0000,
            public_input_size=0, public_output_size=0,
            program_size=0x8_0000, ad_size=0, static_ram=None
            ) -> "LinearMemoryLayout":
        public_input = ELF_TEXT_START + program_size
        assert public_input % WORD_SIZE == 0
        # extra word for the length prefix of the public input
        exit_code = _word_align(public_input + public_input_size
                                + WORD_SIZE)
        public_output = exit_code + WORD_SIZE
        heap = _word_align(public_output + public_output_size)
        stack_bottom = _word_align(heap + max_heap_size)
        stack_top = _align16(stack_bottom + max_stack_size)
        end = stack_top + ad_size
        lay = LinearMemoryLayout(
            public_input=public_input, exit_code=exit_code,
            public_output=public_output, heap=heap,
            stack_bottom=stack_bottom, stack_top=stack_top, end=end,
            static_ram=static_ram)
        lay.validate()
        return lay

    def validate(self):
        assert self.program_end == self.public_input_start
        assert self.public_input_end == self.exit_code
        assert self.public_input_end - self.public_input_start >= WORD_SIZE
        assert self.public_output_start == self.exit_code + WORD_SIZE
        assert self.public_output_start <= self.public_output_end
        assert self.heap_start <= self.heap_end
        assert self.stack_bottom <= self.stack_top
        assert self.stack_top == self.ad_start
        for v in (self.public_input, self.exit_code, self.public_output,
                  self.heap, self.stack_bottom):
            assert v % WORD_SIZE == 0
        assert self.stack_top % 16 == 0
        if self.static_ram is not None:
            lo, hi = self.static_ram
            assert self.program_start <= lo < hi <= self.program_end

    # region accessors (`*_end` one past the end)
    registers_start = 0
    registers_end = NUM_REGISTERS * WORD_SIZE
    public_input_address_location = PUBLIC_INPUT_ADDRESS_LOCATION
    public_output_address_location = PUBLIC_OUTPUT_ADDRESS_LOCATION
    program_start = ELF_TEXT_START

    @property
    def program_end(self):
        return self.public_input

    @property
    def public_input_start(self):
        return self.public_input

    @property
    def public_input_end(self):
        return self.exit_code

    @property
    def public_output_start(self):
        return self.public_output

    @property
    def public_output_end(self):
        return self.heap

    @property
    def heap_start(self):
        return self.heap

    @property
    def heap_end(self):
        return self.stack_bottom

    @property
    def ad_start(self):
        return self.stack_top

    @property
    def ad_end(self):
        return self.end


class LinearMemory:
    """Flat byte store with mode-checked segments."""

    def __init__(self, end: int):
        self.data = bytearray(end)
        self.seg_starts: list = []      # sorted segment start addresses
        self.seg_modes: list = []       # mode per segment
        self.end = end

    def add_segment(self, start: int, end: int, mode: str):
        assert start <= end <= self.end
        if start == end:
            return
        self.seg_starts.append(start)
        self.seg_modes.append((start, end, mode))
        self.seg_starts.sort()
        self.seg_modes.sort()

    def mode_at(self, addr: int) -> str:
        i = bisect.bisect_right(self.seg_starts, addr) - 1
        if i < 0:
            return NA
        start, end, mode = self.seg_modes[i]
        return mode if addr < end else NA

    def fill(self, start: int, data: bytes):
        self.data[start:start + len(data)] = data

    # -- checked accessors (size in {1, 2, 4}; alignment enforced) -----
    def _check(self, addr: int, size: int, write: bool):
        if addr % size:
            raise MemoryError_(f"unaligned {size}-byte access at "
                               f"{addr:#x}")
        if addr + size > self.end:
            raise MemoryError_(f"access past memory end at {addr:#x}")
        mode = self.mode_at(addr)
        if write and mode not in (RW, WO):
            raise MemoryError_(f"write to {mode} memory at {addr:#x}")
        if not write and mode not in (RO, RW):
            raise MemoryError_(f"read from {mode} memory at {addr:#x}")

    def read(self, addr: int, size: int) -> int:
        self._check(addr, size, write=False)
        return int.from_bytes(self.data[addr:addr + size], "little")

    def write(self, addr: int, size: int, value: int):
        self._check(addr, size, write=True)
        self.data[addr:addr + size] = int(value).to_bytes(size, "little",
                                                          signed=False)

    def read_bytes_unchecked(self, addr: int, n: int) -> bytes:
        return bytes(self.data[addr:addr + n])

    def as_words(self) -> np.ndarray:
        return np.frombuffer(bytes(self.data), dtype="<u4")

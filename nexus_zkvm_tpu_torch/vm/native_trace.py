"""Native two-pass tracing: C emulator core + Python orchestration.

Counterpart of `k_trace` (`trace.py`) with the per-instruction hot loop
in C (`native/emulator.c`).  Pass 1 runs the C core under a generous
scratch layout to measure heap usage; pass 2 re-runs under the
optimized layout recording the full SoA trace.  Given the same layout,
the trace is bit-identical to the Python emulator's
(tests/test_native_vm.py proves it).
"""

from __future__ import annotations

import numpy as np

from .decoder import decode_instruction
from .emulator import LinearEmulator
from .isa import ELF_TEXT_START
from .memory import LinearMemoryLayout, RO, RW, WO
from .trace import Trace
from . import native

__all__ = ["k_trace_native", "native_available"]

native_available = native.native_available

_MODE_CODE = {None: 0, RO: 1, RW: 2, WO: 3}


def _decode_cache(program_words):
    n = len(program_words)
    out = {
        "opc": np.zeros(n, np.uint8), "type": np.zeros(n, np.uint8),
        "rd": np.zeros(n, np.uint8), "rs1": np.zeros(n, np.uint8),
        "rs2": np.zeros(n, np.uint8), "imm": np.zeros(n, np.uint32),
        "word": np.asarray([int(w) & 0xFFFFFFFF for w in program_words],
                           np.uint32),
    }
    for i, w in enumerate(program_words):
        ins = decode_instruction(int(w))
        out["opc"][i] = min(int(ins.opcode), 255)
        out["type"][i] = int(ins.itype)
        out["rd"][i] = ins.rd
        out["rs1"][i] = ins.rs1
        out["rs2"][i] = ins.rs2
        out["imm"][i] = ins.imm
    return out


def _setup(layout, program_words, entry, rom_image, ram_image,
           public_input, ad):
    """Initial memory + mode map via the Python emulator's constructor
    (guarantees identical initial state to the reference path)."""
    lin = LinearEmulator(layout, program_words, entry,
                        rom_image=rom_image, ram_image=ram_image,
                        public_input=public_input, ad=ad, record=False)
    mem = np.frombuffer(bytes(lin.mem.data), np.uint8).copy()
    mode = np.zeros(len(mem), np.uint8)
    for start, end, m in lin.mem.seg_modes:
        mode[start:end] = _MODE_CODE[m]
    return lin, mem, mode


def k_trace_native(program_words, entry=None, rom_image=None,
                   ram_image=None, public_input=b"", private_input=b"",
                   ad=b"", k=1, max_steps=None,
                   layout: LinearMemoryLayout | None = None):
    """Returns (View, Trace) like `k_trace`, with the C hot loop."""
    entry = ELF_TEXT_START if entry is None else entry
    prog_size = ((4 * len(program_words) + 0x1000) + 3) & ~3

    if layout is None:
        # pass 1: discovery under a generous scratch layout
        scratch = LinearMemoryLayout.new(
            max_heap_size=0x40_0000, max_stack_size=0x10_0000,
            public_input_size=len(public_input),
            public_output_size=0x200, program_size=prog_size,
            ad_size=(len(ad) + 3) & ~3)
        _, mem, mode = _setup(scratch, program_words, entry, rom_image,
                              ram_image, public_input, ad)
        r = native.run_native(
            mem, mode, scratch.program_start,
            scratch.program_start + 4 * len(program_words),
            _decode_cache(program_words), scratch.exit_code,
            scratch.heap_start, scratch.stack_top, entry,
            private_input, cap=1, max_steps=max_steps, record=False)
        usage = max(0, r["max_heap"] - scratch.heap_start + 1)
        heap_size = (max(usage + 0x1000, 0x1_0000) + 3) & ~3
        layout = LinearMemoryLayout.new(
            max_heap_size=heap_size, max_stack_size=0x10_0000,
            public_input_size=len(public_input),
            public_output_size=0x200, program_size=prog_size,
            ad_size=(len(ad) + 3) & ~3)

    lin, mem, mode = _setup(layout, program_words, entry, rom_image,
                            ram_image, public_input, ad)
    cache = _decode_cache(program_words)
    prog_end = layout.program_start + 4 * len(program_words)
    # counting pass (C is ~10M steps/s; exact allocation beats retries)
    rc = native.run_native(
        mem.copy(), mode, layout.program_start, prog_end, cache,
        layout.exit_code, layout.heap_start, layout.stack_top, entry,
        private_input, cap=1, max_steps=max_steps, record=False)
    r = native.run_native(
        mem, mode, layout.program_start, prog_end, cache,
        layout.exit_code, layout.heap_start, layout.stack_top, entry,
        private_input, cap=max(rc["n_steps"], 1), max_steps=max_steps,
        record=True, kk_cap=rc["n_keccak"])

    # push the final state back into the emulator object and reuse its
    # View construction
    lin.mem.data[:] = r["mem_final"].tobytes()
    lin.logs = r["logs"]
    view = lin.finalize()

    touched = np.nonzero(r["ram_ts"])[0]
    words = r["mem_final"].view("<u4")
    ram_final = {int(4 * w): (int(words[w]), int(r["ram_ts"][w]))
                 for w in touched}
    machine_state = {
        "final_regs": r["regs"],
        "final_reg_ts": r["reg_ts"],
        "ram_final": ram_final,
        "keccak_log": r["keccak_log"],
    }
    return view, Trace(steps=r["steps"], k=k,
                       machine_state=machine_state)

"""Trace generation: two-pass emulation -> (View, Trace).

Counterpart of the reference `k_trace` / `bb_trace` / `k_trace_direct`
(`nexus-zkvm/vm/src/trace.rs:302,356,432`) and `View`
(`vm/src/emulator/utils.rs:113-300`).

The ``Trace`` here is struct-of-arrays: ``steps`` maps field name ->
numpy array over all executed steps (see
`emulator._STEP_FIELDS`).  ``split_by`` slices every field array —
the seam for multi-segment / multi-device proving.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .decoder import Instruction
from .emulator import HarvardEmulator, LinearEmulator, VMExited
from .encoder import encode_instruction
from .isa import Opcode
from .memory import LinearMemoryLayout

__all__ = ["ProgramInfo", "View", "Trace", "k_trace", "bb_trace",
           "k_trace_direct"]


@dataclass
class ProgramInfo:
    initial_pc: int
    program: list               # [(pc, instruction_word)]


@dataclass
class View:
    """The public claim both prover and verifier bind to
    (reference `View`, `vm/src/emulator/utils.rs:113-300`)."""
    memory_layout: LinearMemoryLayout
    program_info: ProgramInfo
    public_input: bytes
    exit_code: int
    public_output: bytes
    associated_data: bytes
    debug_logs: list = field(default_factory=list)
    initial_memory: list = field(default_factory=list)  # [(addr, byte)]

    def exit_code_ok(self) -> bool:
        return self.exit_code == 0

    def logs_text(self) -> str:
        return "".join(b.decode("utf-8", "replace")
                       for b in self.debug_logs)


@dataclass
class Trace:
    steps: dict                 # field -> np array, one entry per step
    k: int = 1
    machine_state: dict | None = None   # see LinearEmulator.machine_state

    @property
    def n_steps(self) -> int:
        return 0 if not self.steps else len(self.steps["clk"])

    def split_by(self, n: int) -> list:
        """Split into ceil(len/n) segments of n steps (last ragged) —
        reference `UniformTrace::split_by` (`vm/src/trace.rs:108-120`)."""
        total = self.n_steps
        out = []
        for lo in range(0, total, n):
            hi = min(lo + n, total)
            out.append(Trace(steps={f: v[lo:hi] for f, v in
                                    self.steps.items()}, k=self.k))
        return out


def k_trace(program_words, entry: int | None = None,
            rom_image: dict | None = None, ram_image: dict | None = None,
            public_input: bytes = b"", private_input: bytes = b"",
            ad: bytes = b"", k: int = 1, max_steps: int | None = None,
            backend: str = "python"):
    """Two-pass trace: Harvard discovery, then Linear recording.

    program_words: list of u32 at `ELF_TEXT_START` (or ElfFile fields);
    returns (View, Trace).  Reference: `vm/src/trace.rs:302-348`.
    backend="native" routes the hot loop to the C emulator
    (bit-identical trace given the same layout); "auto" prefers native
    when the toolchain is available.
    """
    from .isa import ELF_TEXT_START
    entry = ELF_TEXT_START if entry is None else entry

    if backend in ("native", "auto"):
        from .native_trace import k_trace_native, native_available
        from .decoder import decode_instruction as _dec
        # dynamic precompiles execute arbitrary host Python -- those
        # programs stay on the Python emulator (static check)
        has_precompile = any(
            _dec(int(w)).opcode == Opcode.PRECOMPILE
            for w in program_words)
        if has_precompile and backend == "native":
            raise RuntimeError(
                "native emulator cannot run dynamic precompiles")
        if native_available() and not has_precompile:
            view, trace = k_trace_native(
                program_words, entry=entry, rom_image=rom_image,
                ram_image=ram_image, public_input=public_input,
                private_input=private_input, ad=ad, k=k,
                max_steps=max_steps)
            return view, _k_pad(trace, k)
        if backend == "native":
            raise RuntimeError("native emulator unavailable")

    harv = HarvardEmulator(program_words, base=ELF_TEXT_START, entry=entry,
                           rom_image=rom_image, ram_image=ram_image,
                           public_input=public_input,
                           private_input=private_input, ad=ad)
    try:
        harv.execute(max_steps)
    except VMExited:
        pass

    lin = LinearEmulator.from_harvard(
        harv, program_words, entry, rom_image=rom_image,
        ram_image=ram_image, public_input=public_input,
        private_input=private_input, ad=ad)
    try:
        lin.execute(max_steps)
    except VMExited:
        pass
    view = lin.finalize()
    return view, _k_pad(Trace(steps=lin.recorder.arrays(), k=k,
                              machine_state=lin.machine_state()), k)


def _k_pad(trace: "Trace", k: int) -> "Trace":
    """Pad the final block to `k` steps with UNIMPL rows (reference
    `k_step` padding, `vm/src/trace.rs:218-247`): clk keeps counting,
    pc freezes at the last next_pc, nothing executes."""
    n = trace.n_steps
    if k <= 1 or n == 0 or n % k == 0:
        return trace
    pad = k - n % k
    s = trace.steps
    out = {}
    for name, arr in s.items():
        ext = np.zeros(pad, arr.dtype)
        if name == "clk":
            ext[:] = s["clk"][-1] + 1 + np.arange(pad)
        elif name in ("pc", "next_pc"):
            ext[:] = s["next_pc"][-1]
        elif name == "opcode":
            ext[:] = int(Opcode.UNIMPL)
        elif name == "word":
            ext[:] = 0xC000_0073
        out[name] = np.concatenate([arr, ext])
    return Trace(steps=out, k=k, machine_state=trace.machine_state)


def bb_trace(program_words, **kw):
    """Basic-block trace (k = block size); same machinery, k tagged 0."""
    view, trace = k_trace(program_words, **kw)
    trace.k = 0
    return view, trace


def k_trace_direct(instructions, k: int = 1,
                   public_input: bytes = b"", private_input: bytes = b"",
                   max_steps: int | None = None):
    """Trace a synthetic instruction list with a dummy memory layout —
    the chip-test entry (reference `k_trace_direct`,
    `vm/src/trace.rs:356`).  instructions: list[Instruction] or u32.
    Appends an implicit exit if the program falls off the end.
    """
    words = [encode_instruction(i) if isinstance(i, Instruction) else
             int(i) for i in instructions]
    # run until the pc leaves the program (no explicit exit needed):
    # append "li a7,0x201; ecall" epilogue
    epilogue = [0x20100893, 0x00000073]  # addi x17,x0,0x201 ; ecall
    return k_trace(words + epilogue, public_input=public_input,
                   private_input=private_input, k=k, max_steps=max_steps)

"""Machine v1's verifier side: the components rebuilt from the public
View, the transcript bound to it, and the size rules a proof must keep.
"""

from __future__ import annotations

import numpy as np

from ..channel import Blake2sChannel
from ..verifier import verify
from .cpu import CpuComponent, ProgramTable, decode_program_table
from .mext import MExtComponent
from .keccak import KeccakComponent
from .memside import RegFile, RamTouched, MemInit, OutputCheck
from .precomp import proven_precompile_components
from .tables import RangeTable, BitOpTable, ShiftTable

__all__ = ["verify_machine", "build_components"]


def _clog2(n: int, lo: int = 3) -> int:
    k = max(1, int(n) - 1).bit_length()
    return max(k, lo)


def _static_window(view):
    """Writable static-RAM address window from the public image:
    initial-memory entries above the program text but below the input
    region (RW .data/.bss of an ELF guest)."""
    lay = view.memory_layout
    addrs = [a for a, _ in view.initial_memory
             if lay.program_start <= a < lay.public_input_start]
    prog_end = max((pc + 4 for pc, _ in view.program_info.program),
                   default=lay.program_start)
    static = [a for a in addrs if a >= prog_end]
    if not static:
        return None, None
    return min(static) & ~3, lay.program_end


def build_components(view, n_segments: int = 1):
    lay = view.memory_layout
    assert lay.end < (1 << 30), "memory layout exceeds M31-safe range"
    st_lo, st_hi = _static_window(view)
    cpus = [CpuComponent(entry=view.program_info.initial_pc,
                         exit_addr=lay.exit_code,
                         heap_start=lay.heap_start,
                         stack_top=lay.stack_top,
                         static_lo=st_lo, static_hi=st_hi, seg=s)
            for s in range(n_segments)]
    prog = ProgramTable(decode_program_table(view))
    regf = RegFile(stack_top=lay.stack_top)
    ram = RamTouched(heap_start=lay.heap_start)
    image_addrs, image_vals = _full_image(view)
    meminit = MemInit(image_addrs, image_vals)
    outchk = OutputCheck(view)
    tables = [RangeTable(8), RangeTable(7), RangeTable(6), RangeTable(3),
              BitOpTable("and"), BitOpTable("xor"),
              ShiftTable("l"), ShiftTable("r")]
    mext = MExtComponent()
    keccak = KeccakComponent()
    pre_comps = proven_precompile_components()
    comps = cpus + [prog, regf, ram, meminit, outchk, mext, keccak] \
        + pre_comps + tables
    fixed_sizes = {
        "program": _clog2(len(view.program_info.program)),
        "regfile": 5,
        "mem_init": _clog2(len(image_addrs)),
        "output_check": _clog2(len(outchk.addrs)),
    }
    for t in tables:
        fixed_sizes[t.name] = t.log_rows
    return comps, fixed_sizes, (st_lo, st_hi)


def _full_image(view):
    """Every word in [0, heap_start) with its public initial value."""
    lay = view.memory_layout
    data = np.zeros(lay.heap_start, np.uint8)
    for pc, w in view.program_info.program:
        data[pc:pc + 4] = np.frombuffer(
            int(w).to_bytes(4, "little"), np.uint8)
    for a, b in view.initial_memory:
        data[a] = b
    vals = data.view("<u4").astype(np.uint32)
    addrs = np.arange(len(vals), dtype=np.uint32) * 4
    return addrs, vals


def _mix_view(channel, view):
    """Bind the transcript to the public claim."""
    import hashlib
    lay = view.memory_layout
    h = hashlib.blake2s()
    h.update(np.asarray([view.program_info.initial_pc, lay.public_input,
                         lay.exit_code, lay.public_output, lay.heap,
                         lay.stack_bottom, lay.stack_top, lay.end],
                        "<u4").tobytes())
    for pc, w in view.program_info.program:
        h.update(np.asarray([pc, w], "<u4").tobytes())
    for a, b in view.initial_memory:
        h.update(np.asarray([a, b], "<u4").tobytes())
    h.update(len(view.public_input).to_bytes(4, "little"))
    h.update(view.public_input)
    h.update(int(view.exit_code & 0xFFFFFFFF).to_bytes(4, "little"))
    h.update(view.public_output)
    h.update(view.associated_data)
    channel.mix_u32s(np.frombuffer(h.digest(), "<u4").astype(np.uint32))


def verify_machine(view, proof: MachineProof,
                   config, device="cpu") -> bool:
    log_sizes = list(proof.stark.log_sizes)
    try:
        n_fixed = len(build_components(view, 1)[0]) - 1
        n_segments = len(log_sizes) - n_fixed
        if n_segments < 1:
            return False
        comps, fixed_sizes, _ = build_components(view, n_segments)
    except (AssertionError, ValueError):
        return False
    if len(log_sizes) != len(comps):
        return False
    # canonical sizes for all view-determined components; the CPU and
    # RamTouched sizes are the prover's (content-dependent), bounded
    for i, comp in enumerate(comps):
        want = fixed_sizes.get(comp.name)
        if want is not None and log_sizes[i] != want:
            return False
        if log_sizes[i] > 28:
            return False
    channel = Blake2sChannel()
    _mix_view(channel, view)
    return verify(comps, proof.stark, channel, config, device=device)

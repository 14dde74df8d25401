"""machine2's verifier side: one component per instruction family, the
memory side, tables and circuits shared with machine v1.
"""

from __future__ import annotations

from ..channel import Blake2sChannel
from ..machine.cpu import ProgramTable, decode_program_table
from ..machine.driver import (_clog2, _static_window, _full_image,
                              _mix_view)
from ..machine.keccak import KeccakComponent
from ..machine.memside import RegFile, RamTouched, MemInit, OutputCheck
from ..machine.mext import MExtComponent
from ..machine.precomp import proven_precompile_components
from ..machine.tables import RangeTable, BitOpTable, ShiftTable
from ..verifier import verify
from .exec_components import EXEC_FAMILIES, ExLoad, ExStore, ExSys

__all__ = ["verify_machine2", "build_components2"]

# the exec chain walks one step per row; family sizes must keep every
# timestamp 3*clk+3 below TS_CHECK = 2^30-1
MAX_FAMILY_LOG = 26


def build_components2(view):
    lay = view.memory_layout
    assert lay.end < (1 << 30), "memory layout exceeds M31-safe range"
    st_lo, st_hi = _static_window(view)
    fams = []
    for fam_cls in EXEC_FAMILIES:
        if fam_cls is ExLoad:
            fams.append(ExLoad(lay.exit_code, lay.heap_start))
        elif fam_cls is ExStore:
            fams.append(ExStore(lay.exit_code, st_lo, st_hi))
        elif fam_cls is ExSys:
            fams.append(ExSys(view.program_info.initial_pc,
                              lay.exit_code, lay.heap_start,
                              lay.stack_top))
        else:
            fams.append(fam_cls())
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
    comps = fams + [prog, regf, ram, meminit, outchk, mext, keccak] \
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


def verify_machine2(view, proof: MachineProof,
                    config, device="cpu") -> bool:
    try:
        comps, fixed_sizes, _ = build_components2(view)
    except (AssertionError, ValueError):
        return False
    log_sizes = list(proof.stark.log_sizes)
    if len(log_sizes) != len(comps):
        return False
    fam_names = {f.name for f in EXEC_FAMILIES}
    total_rows = 0
    for i, comp in enumerate(comps):
        want = fixed_sizes.get(comp.name)
        if want is not None and log_sizes[i] != want:
            return False
        if comp.name in fam_names:
            if log_sizes[i] > MAX_FAMILY_LOG:
                return False
            total_rows += 1 << log_sizes[i]
        elif log_sizes[i] > 28:
            return False
    # clk is chained one per row: total rows bound keeps ts < TS_CHECK
    if total_rows > (1 << 28):
        return False
    channel = Blake2sChannel()
    _mix_view(channel, view)
    return verify(comps, proof.stark, channel, config, device=device)

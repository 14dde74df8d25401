"""machine2 prove/verify driver: (View, Trace) -> proof -> check.

Counterpart of the reference's second-generation prover driver
(`nexus-zkvm/prover2/machine/src/prove.rs:34-146`,
`verify.rs:28-101`): per-instruction-family components, each at its own
power-of-two size, stitched by shared LogUp relations.  The memory-side
components, M-ext / keccak / precompile circuits and lookup tables are
the exact objects of machine v1 (`machine/driver.py`): only the CPU is
split.

The family fills are host numpy (`exec_components.py`, scope
``f:machine2``); each family's (columns, 2^log) matrix then goes to
``device`` once, as int32, and the prover commits it there.

Decision record, segments: machine v1 segments an execution into
several CPU component instances.  machine2 adds no segment axis: the
per-family split already bounds each component to its opcode
population, the shared relations make row order irrelevant (so the
families are the split), and a single large family is composed in row
passes by the prover's memory mode (``prover.MemoryConfig``, chosen by
size) when its 4x-domain columns exceed the budget.
"""

from __future__ import annotations

import numpy as np

from ..channel import Blake2sChannel
from ..machine.cpu import ProgramTable, decode_program_table
from ..machine.driver import (MachineProof, _clog2, _static_window,
                              _full_image, _mix_view, _table_mults,
                              _ram_data, _memside_emits)
from ..machine.keccak import (KeccakComponent, KECCAK_SCHEMA,
                              fill_keccak, BLOCK as KECCAK_BLOCK)
from ..machine.memside import (RegFile, RamTouched, MemInit, OutputCheck,
                               REG_SCHEMA, RAM_SCHEMA, OUT_SCHEMA,
                               fill_reg_file, fill_ram_touched)
from ..machine.mext import MExtComponent, MEXT_SCHEMA, M_OPS, fill_mext
from ..machine.precomp import (PRECOMP_SCHEMA,
                               proven_precompile_components,
                               proven_indices, precompile_rows)
from ..machine.tables import RangeTable, BitOpTable, ShiftTable
from ..prover import MemoryConfig, PcsConfig, prove, verify
from ..utils.device import from_u32, resolve_device
from ..utils.profile import scope
from ..vm.isa import Opcode
from .exec_components import (EXEC_FAMILIES, ExLoad, ExStore, ExSys,
                              family_rows, fill_family)

__all__ = ["prove_machine2", "verify_machine2", "build_machine2_traces",
           "build_components2"]

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


def build_machine2_traces(view, trace, device="cuda"):
    """(View, Trace) -> (components, log sizes, main traces).

    Each family's trace is a (columns, 2^log) int32 tensor on
    ``device``, filled on the host and copied there once; every other
    component's is a list of numpy uint32 columns."""
    dev = resolve_device(device)
    comps, fixed_sizes, _ = build_components2(view)
    by_name = {c.name: c for c in comps}
    lay = view.memory_layout

    s = trace.steps
    n_steps = int(len(s["clk"]))
    # trailing UNIMPL rows (k-block padding) == power-of-two padding
    unimpl = s["opcode"] == int(Opcode.UNIMPL)
    if unimpl.any():
        assert unimpl[np.argmax(unimpl):].all(), \
            "UNIMPL steps must be a trailing block"
        n_steps = int(np.argmax(unimpl))
        s = {k: v[:n_steps] for k, v in s.items()}

    present = set(np.unique(s["opcode"]).tolist())
    supported = set()
    for fam_cls in EXEC_FAMILIES:
        supported |= {int(op) for op in fam_cls.FLAGS}
    assert present <= supported, \
        f"unsupported opcodes in trace: {present - supported}"

    fam_data = {}
    emit_sets = []
    with scope("f:machine2"):
        for fam_cls in EXEC_FAMILIES:
            comp = by_name[fam_cls.name]
            rows = family_rows(s["opcode"], fam_cls)
            log = min(_clog2(int(rows.sum())), MAX_FAMILY_LOG)
            assert int(rows.sum()) <= (1 << log), \
                f"{fam_cls.name} exceeds MAX_FAMILY_LOG rows"
            fill, emits = fill_family(comp, s, rows, log, view)
            fam_data[fam_cls.name] = (log, comp.SCHEMA.to_columns(fill))
            emit_sets.append(emits)

    with scope("f:ram"):
        addrs, inits, finals, fts, oc_prev = _ram_data(trace, view)
    ram_log = _clog2(len(addrs) + 1)
    ram_fill = fill_ram_touched(addrs, inits, finals, fts,
                                lay.heap_start, ram_log)
    out_fill = by_name["output_check"].fill(
        oc_prev, fixed_sizes["output_check"])
    ms = trace.machine_state
    reg_fill = fill_reg_file(ms["final_regs"], ms["final_reg_ts"])

    n_m = int(np.isin(trace.steps["opcode"],
                      [int(o) for o in M_OPS]).sum())
    mext_log = _clog2(n_m)
    mext_fill, mext_emits = fill_mext(trace, mext_log)

    pre_steps = trace.steps["opcode"] == int(Opcode.PRECOMPILE)
    used_idx = set(np.unique(trace.steps["imm"][pre_steps]).tolist())
    unproven = used_idx - proven_indices()
    if unproven:
        raise ValueError(
            f"trace uses precompiles without circuits: {sorted(unproven)}")
    pre_fills = {}
    for pcomp in by_name.values():
        if not hasattr(pcomp, "INDEX"):
            continue
        n_p = int(precompile_rows(trace, pcomp.INDEX).sum())
        plog = _clog2(n_p)
        pre_fills[pcomp.name] = (plog,) + pcomp.fill(trace, plog)

    kk_log = (trace.machine_state or {}).get("keccak_log", [])
    n_kk = int((trace.steps["opcode"] == int(Opcode.KECCAKF)).sum())
    assert n_kk == len(kk_log), \
        "keccak steps without recorded state (use the python backend)"
    keccak_log2 = _clog2(max(1, len(kk_log)) * KECCAK_BLOCK)
    kk_fill, kk_emits = fill_keccak(kk_log, keccak_log2)

    # program fetch multiplicities over the real steps
    fetch_rows = ((s["pc"].astype(np.int64) - lay.program_start) // 4)
    prog_mult = np.bincount(fetch_rows,
                            minlength=1 << fixed_sizes["program"]
                            ).astype(np.uint32)
    assert len(prog_mult) == 1 << fixed_sizes["program"]

    g_addrs = addrs[np.asarray(ram_fill["g"][:len(addrs)], bool)]
    mi_mult = np.zeros(1 << fixed_sizes["mem_init"], np.uint32)
    mi_mult[g_addrs // 4] = 1

    with scope("f:mults"):
        mults = _table_mults(comps, fixed_sizes,
                             emit_sets + [mext_emits, kk_emits,
                                          _memside_emits(ram_fill, out_fill)]
                             + [e for _, _, e in pre_fills.values()])

    log_sizes, traces = [], []
    for comp in comps:
        if comp.name in fam_data:
            log, cols = fam_data[comp.name]
            log_sizes.append(log)
            with scope("f:upload"):
                traces.append(from_u32(np.stack(cols), dev))
        elif comp.name == "program":
            log_sizes.append(fixed_sizes["program"])
            traces.append([prog_mult])
        elif comp.name == "regfile":
            log_sizes.append(5)
            traces.append(REG_SCHEMA.to_columns(reg_fill))
        elif comp.name == "ram_touched":
            log_sizes.append(ram_log)
            traces.append(RAM_SCHEMA.to_columns(ram_fill))
        elif comp.name == "mem_init":
            log_sizes.append(fixed_sizes["mem_init"])
            traces.append([mi_mult])
        elif comp.name == "output_check":
            log_sizes.append(fixed_sizes["output_check"])
            traces.append(OUT_SCHEMA.to_columns(out_fill))
        elif comp.name == "mext":
            log_sizes.append(mext_log)
            traces.append(MEXT_SCHEMA.to_columns(mext_fill))
        elif comp.name == "keccak":
            log_sizes.append(keccak_log2)
            traces.append(KECCAK_SCHEMA.to_columns(kk_fill))
        elif comp.name in pre_fills:
            plog, pfill, _ = pre_fills[comp.name]
            log_sizes.append(plog)
            traces.append(PRECOMP_SCHEMA.to_columns(pfill))
        else:
            log_sizes.append(fixed_sizes[comp.name])
            traces.append([mults[comp.name]])
    return comps, log_sizes, traces


def prove_machine2(view, trace, config: PcsConfig = PcsConfig(),
                   device="cuda",
                   memory: MemoryConfig | None = None) -> MachineProof:
    """``memory``: where the prover keeps its data (the large-trace
    memory mode is chosen by size; None: `MemoryConfig.for_device`);
    the proof is the same under any."""
    with scope("fills"):
        comps, log_sizes, traces = build_machine2_traces(view, trace,
                                                         device=device)
    channel = Blake2sChannel()
    _mix_view(channel, view)
    # the traces were made here: prove frees each once it is committed
    proof = prove(comps, log_sizes, traces, channel, config, device=device,
                  memory=memory, release_traces=True)
    return MachineProof(stark=proof)


def verify_machine2(view, proof: MachineProof,
                    config: PcsConfig = PcsConfig(), device="cuda") -> bool:
    resolve_device(device)
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

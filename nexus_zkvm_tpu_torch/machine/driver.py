"""Machine prove/verify driver: (View, Trace) -> proof -> check.

Counterpart of the reference's `prove` / `verify` facade
(`nexus-zkvm/prover/src/lib.rs:26-47`) over
`Machine::prove_with_extensions` (`prover/src/machine.rs:130-297`).

The verifier rebuilds every component from the public View (program
table, memory image, output expectation, lookup tables are all
preprocessed and therefore verifier-recomputed) and enforces the
canonical per-component sizes, so a proof only verifies for the exact
program + public IO claimed.  The transcript is additionally seeded
with a Blake2s digest of the View (the reference mixes the associated
data + log-sizes, `machine.rs:197-206`).

The CPU component is filled on ``device`` from the emulator's step
record (``fill_dev.fill_cpu_dev``: kernel K5 on a CUDA device, its plain
PyTorch version on the CPU); its (193, N) matrix goes to the prover
without a host round trip, and only the table histograms come back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..channel import Blake2sChannel
from ..prover import MemoryConfig, PcsConfig, prove, verify
from ..prover.stark import Proof
from ..utils.device import resolve_device
from ..utils.profile import scope
from .cpu import CpuComponent, ProgramTable, decode_program_table
from .fill_dev import fill_cpu_dev, RELATION_SIZES
from .mext import MExtComponent, MEXT_SCHEMA, M_OPS, fill_mext
from .keccak import (KeccakComponent, KECCAK_SCHEMA, fill_keccak,
                     BLOCK as KECCAK_BLOCK)
from .memside import (RegFile, RamTouched, MemInit, OutputCheck,
                      TS_CHECK, REG_SCHEMA, RAM_SCHEMA, OUT_SCHEMA,
                      fill_reg_file, fill_ram_touched)
from .precomp import (PRECOMP_SCHEMA, proven_precompile_components,
                      proven_indices, precompile_rows)
from .tables import RangeTable, BitOpTable, ShiftTable

__all__ = ["prove_machine", "verify_machine", "MachineProof",
           "build_components"]


@dataclass
class MachineProof:
    stark: Proof

    def size_estimate(self) -> int:
        return self.stark.size_estimate()


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


def _table_mults(components, fixed_sizes, emit_sets, extra_counts=()):
    """Main (multiplicity) columns for the lookup tables.

    emit_sets: host dicts relation -> flat index arrays;
    extra_counts: per-segment (5320,) int32 DEVICE histograms of the CPU
    fill (`fill_cpu_dev`, relations in RELATION_SIZES order), fetched in
    one transfer and added."""
    from .tables import count_multiplicity, _Table
    fetched = {}
    if extra_counts:
        hists = torch.stack(list(extra_counts)).cpu().numpy() \
            .view(np.uint32)
        for h in hists:
            lo = 0
            for rel, size in RELATION_SIZES.items():
                fetched.setdefault(rel, []).append(h[lo:lo + size])
                lo += size
    out = {}
    for comp in components:
        if not isinstance(comp, _Table):
            continue
        idx = [e[comp.relation] for e in emit_sets if comp.relation in e]
        idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        mult = count_multiplicity(comp, idx, fixed_sizes[comp.name])
        for v in fetched.get(comp.relation, ()):
            mult[: len(v)] += v
        out[comp.name] = mult
    return out


def _ram_data(trace, view):
    """Touched-word table data + OutputCheck prev timestamps."""
    lay = view.memory_layout
    ms = trace.machine_state
    ram_final = dict(ms["ram_final"])          # word -> (val, last_ts)
    s = trace.steps
    mem_rows = s["mem_size"] > 0
    words = (s["mem_addr"][mem_rows] & ~np.uint32(3)).astype(np.int64)
    prev_vals = s["mem_prev_val"][mem_rows].astype(np.int64)
    clks = s["clk"][mem_rows].astype(np.int64)
    # keccakf instructions access 50 words each (one pair per word)
    for e in (ms.get("keccak_log") or []):
        kw = int(e["addr"]) + 4 * np.arange(50, dtype=np.int64)
        words = np.concatenate([words, kw])
        prev_vals = np.concatenate(
            [prev_vals, np.asarray(e["in_words"], np.int64)])
        clks = np.concatenate(
            [clks, np.full(50, int(e["clk"]), np.int64)])
    # first access per word gives the initial value
    order = np.lexsort((clks, words))
    w_sorted = words[order]
    first = np.ones(len(w_sorted), bool)
    first[1:] = w_sorted[1:] != w_sorted[:-1]
    init_by_word = {int(w): int(v) for w, v in
                    zip(w_sorted[first], prev_vals[order][first])}

    out_words = list(range(lay.exit_code, lay.public_output_end, 4))
    touched = sorted(set(init_by_word) | set(out_words))
    image_addrs, image_vals = _full_image(view)
    image = {int(a): int(v) for a, v in zip(image_addrs, image_vals)}

    addrs, inits, finals, fts = [], [], [], []
    oc_prev_ts = {}
    for w in touched:
        init = init_by_word.get(w)
        if init is None:                     # untouched output word
            init = image.get(w, 0)
        fin, lts = ram_final.get(w, (init, 0))
        if lay.exit_code <= w < lay.public_output_end:
            oc_prev_ts[w] = lts
            lts = TS_CHECK                   # OutputCheck virtual read
        addrs.append(w)
        inits.append(init)
        finals.append(fin)
        fts.append(lts)
    return (np.asarray(addrs, np.int64), np.asarray(inits, np.uint64),
            np.asarray(finals, np.uint64), np.asarray(fts, np.uint64),
            oc_prev_ts)


def _memside_emits(ram_fill, out_fill):
    """Range-check emissions of RamTouched/OutputCheck (match their
    evaluate() fractions exactly)."""
    e256, e64 = [], []
    for name in ("d", "zd"):
        for i in range(3):
            e256.append(ram_fill[name][:, i].astype(np.int64))
        e64.append(ram_fill[name][:, 3].astype(np.int64))
    for i in range(3):
        e256.append(out_fill["tsd"][:, i].astype(np.int64))
    e64.append(out_fill["tsd"][:, 3].astype(np.int64))
    return {"r256": np.concatenate(e256), "r64": np.concatenate(e64)}


def build_machine_traces(view, trace, segment_log: int | None = None,
                         min_cpu_log: int | None = None, device="cuda"):
    """(View, Trace) -> (components, log_sizes, main traces).

    The complete fill for every component.  `segment_log` splits the
    execution into 2^segment_log-step segments, each its own CPU
    component (chains connect through the shared relations).  Each CPU
    component's trace is a (193, 2^log) int32 tensor on ``device``;
    every other component's is a list of numpy uint32 columns.
    """
    dev = resolve_device(device)
    if segment_log is not None:
        segs = trace.split_by(1 << segment_log)
    else:
        segs = [trace]
    with scope("f:components"):
        comps, fixed_sizes, (st_lo, st_hi) = build_components(
            view, n_segments=len(segs))
    by_name = {c.name: c for c in comps}
    lay = view.memory_layout

    cpu_logs = []
    cpu_dev = []                 # per-segment device matrix
    cpu_dev_counts = []          # per-segment device table histograms
    for seg in segs:
        log = _clog2(len(seg.steps["clk"]),
                     lo=4 if min_cpu_log is None else min_cpu_log)
        # the step record goes to the device once; every column and
        # table histogram is derived there
        with scope("f:cpu"):
            mat, dcounts = fill_cpu_dev(seg, view, log, st_lo, st_hi, dev)
        cpu_dev.append(mat)
        cpu_dev_counts.append(dcounts)
        cpu_logs.append(log)

    with scope("f:ram"):
        addrs, inits, finals, fts, oc_prev = _ram_data(trace, view)
    # +1 guarantees a padding row so the sorted-address next-row
    # constraint does not wrap onto row 0
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

    # proven precompiles: every dynamic-precompile step must have a
    # circuit (ref `PrecompileInstruction::circuit`,
    # `precompiles/src/traits.rs:38-46`) -- reject, never skip
    from ..vm.isa import Opcode as _Opcode
    pre_steps = trace.steps["opcode"] == int(_Opcode.PRECOMPILE)
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
    n_kk = int((trace.steps["opcode"] == 64).sum())
    assert n_kk == len(kk_log), \
        "keccak steps without recorded state (use the python backend)"
    keccak_log2 = _clog2(max(1, len(kk_log)) * KECCAK_BLOCK)
    kk_fill, kk_emits = fill_keccak(kk_log, keccak_log2)

    # program fetch multiplicities (k-padding UNIMPL rows fetch nothing)
    from ..vm.isa import Opcode as _Opc
    real = trace.steps["opcode"] != int(_Opc.UNIMPL)
    fetch_rows = ((trace.steps["pc"][real].astype(np.int64)
                   - lay.program_start) // 4)
    prog_mult = np.bincount(fetch_rows,
                            minlength=1 << fixed_sizes["program"]
                            ).astype(np.uint32)
    assert len(prog_mult) == 1 << fixed_sizes["program"]

    # mem-init multiplicities: image rows consumed by touched g-rows
    g_addrs = addrs[np.asarray(ram_fill["g"][:len(addrs)], bool)]
    mi_mult = np.zeros(1 << fixed_sizes["mem_init"], np.uint32)
    mi_mult[g_addrs // 4] = 1

    with scope("f:mults"):
        mults = _table_mults(comps, fixed_sizes,
                             [mext_emits, kk_emits,
                             _memside_emits(ram_fill, out_fill)]
                             + [e for _, _, e in pre_fills.values()],
                             extra_counts=cpu_dev_counts)

    log_sizes, traces = [], []
    seg_i = 0
    for comp in comps:
        if comp.name.startswith("cpu"):
            log_sizes.append(cpu_logs[seg_i])
            traces.append(cpu_dev[seg_i])
            seg_i += 1
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


def prove_machine(view, trace, config: PcsConfig = PcsConfig(),
                  segment_log: int | None = None, device="cuda",
                  memory: MemoryConfig | None = None) -> MachineProof:
    """``memory``: where the prover keeps its data (the large-trace
    memory mode is chosen by size; None: `MemoryConfig.for_device`);
    the proof is the same under any."""
    with scope("fills"):
        comps, log_sizes, traces = build_machine_traces(
            view, trace, segment_log, device=device)
    channel = Blake2sChannel()
    _mix_view(channel, view)
    # the traces were made here: prove frees each once it is committed
    proof = prove(comps, log_sizes, traces, channel, config, device=device,
                  memory=memory, release_traces=True)
    return MachineProof(stark=proof)


def verify_machine(view, proof: MachineProof,
                   config: PcsConfig = PcsConfig(), device="cuda") -> bool:
    resolve_device(device)
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

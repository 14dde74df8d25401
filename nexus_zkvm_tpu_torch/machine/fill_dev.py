"""Device CPU trace fill (kernel K5): step record in, committed columns out.

Replaces the host-numpy `fill_cpu` (`machine/cpu.py`) on the prover's
path: the emulator's step record goes to the device once as 18 uint32
rows of N (masked and delta-coded on the host by `_host_prep`), and one
pass derives every one of the CPU component's 193 main columns plus the
histograms of the eight lookup tables it feeds.  The reference fills its
columns row by row on the host (`nexus-zkvm/prover/src/machine.rs:
163-171`).

`cpu_fill` launches ``csrc/fill.cu`` on a CUDA tensor and runs
`cpu_fill_plain`, the same function in plain PyTorch, on a CPU tensor.
The kernel's opcode sets, flag columns and column slots are generated
from ``cpu.py``'s tables by `cuda_header` into ``csrc/fill_tables.cuh``,
not copied by hand; the tests hold that file equal to `cuda_header()`.
After a change to those tables, regenerate it:

    python -m nexus_zkvm_tpu_torch.machine.fill_dev

Value parity: `fill_cpu_dev` gives EXACTLY the matrix
`CPU_SCHEMA.to_columns(fill_cpu(...))` would give, and table counts
equal to `count_multiplicity` over `fill_cpu`'s emit arrays
(`tests/test_torch_machine.py`).

Arithmetic: the plain version computes in int64 and masks to 32 bits
after every subtraction that wraps in uint32 (`_U32`); the kernel uses
`uint32_t`, and `int32_t` where the reference shifts arithmetically.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..ops.field import m31_inv
from ..utils.device import from_u32, resolve_device
from ..vm.isa import Opcode, SyscallCode
from .cpu import (CPU_SCHEMA, OP_FLAGS, SYS_FLAGS, _FLAG_IDX,
                  _R_TYPE, _S_TYPE, _B_TYPE, _IMM_C, _LOADS, _CMP_OPS,
                  _SGN_OPS, _SLL_OPS, _SRL_OPS, _SRA_OPS, _WRITE_OPS)

__all__ = ["fill_cpu_dev", "step_rows", "cpu_fill", "cpu_fill_plain",
           "cuda_header", "CUDA_HEADER", "RELATION_SIZES", "N_HIST"]

CUDA_HEADER = Path(kernels.CSRC) / "fill_tables.cuh"

# shipped step-row order (all uint32, length N, padding rows zero)
_ROWS = ["opcode", "rd", "rs1", "rs2", "pc_rel", "npc_rel", "imm",
         "b_val", "c_arr", "a_arr", "a_prev", "d1", "d2", "d3",
         "maddr_m", "wp", "wn", "mtsd"]
_RIDX = {name: i for i, name in enumerate(_ROWS)}

# params row order
_PARAMS = ["prog_start", "exit_code", "heap_start", "st_lo", "st_hi",
           "clk0", "n"]

# table relation -> number of rows (must match machine/tables.py); the
# histograms are one vector of N_HIST bins in this order
RELATION_SIZES = {"r256": 256, "r64": 64, "r128": 128, "r8": 8,
                  "and4": 256, "xor4": 256, "shl8": 9 * 256,
                  "shr8": 8 * 256}
N_HIST = sum(RELATION_SIZES.values())

_U32 = 0xFFFFFFFF

# opcode sets the kernel tests by bitmask, by name in cpu.py
_OPSETS = {"R_S_B": _R_TYPE | _S_TYPE | _B_TYPE, "LOADS": _LOADS,
           "S_TYPE": _S_TYPE, "CMP": _CMP_OPS, "SGN": _SGN_OPS,
           "SLL": _SLL_OPS, "SHR": _SRL_OPS | _SRA_OPS, "SRA": _SRA_OPS,
           "WRITE": _WRITE_OPS}


def _np_opset_mask(opc: np.ndarray, ops) -> np.ndarray:
    table = np.zeros(256, bool)
    for o in ops:
        table[int(o)] = True
    return table[opc]


def _host_prep(s, n: int, N: int, view, static_lo, static_hi):
    """Mask/delta transforms on the raw step arrays (host, cheap).

    Zeroing under the same masks the device recomputes keeps the
    bit-packed transfer small (deltas and masked values are tiny on
    typical traces) AND matches fill_cpu's committed values exactly."""
    lay = view.memory_layout
    opc = s["opcode"][:n]
    b_val = s["b_val"][:n].astype(np.uint32)
    is_ecall = opc == int(Opcode.ECALL)
    s_halt = is_ecall & (b_val == int(SyscallCode.EXIT))
    io_write = np.zeros(n, bool)
    for code in (SyscallCode.WRITE, SyscallCode.READ_PRIVATE_INPUT,
                 SyscallCode.OVERWRITE_STACK_POINTER,
                 SyscallCode.OVERWRITE_HEAP_POINTER):
        io_write |= is_ecall & (b_val == int(code))
    writes = _np_opset_mask(opc, _WRITE_OPS) | io_write
    uses_rs2 = _np_opset_mask(opc, _R_TYPE | _S_TYPE | _B_TYPE) \
        | is_ecall
    ls = _np_opset_mask(opc, _LOADS | _S_TYPE)
    is_mem = ls | s_halt
    imm = s["imm"][:n].astype(np.uint32)
    clk = s["clk"][:n].astype(np.uint32)
    c_arr = np.where(uses_rs2, s["c_val"][:n].astype(np.uint32),
                     np.where(_np_opset_mask(opc, _IMM_C), imm, 0))
    prog_start = np.uint32(lay.program_start)

    rows = np.zeros((len(_ROWS), N), np.uint32)

    def put(name, v):
        rows[_RIDX[name], :n] = v

    put("opcode", opc)
    put("rd", s["rd"][:n])
    put("rs1", s["rs1"][:n])
    put("rs2", s["rs2"][:n])
    put("pc_rel", s["pc"][:n].astype(np.uint32) - prog_start)
    put("npc_rel", s["next_pc"][:n].astype(np.uint32) - prog_start)
    put("imm", imm)
    put("b_val", b_val)
    put("c_arr", c_arr)
    put("a_arr", np.where(writes, s["a_val"][:n].astype(np.uint32), 0))
    put("a_prev", np.where(writes, s["a_prev"][:n].astype(np.uint32), 0))
    put("d1", 3 * clk + 1 - s["ts1_prev"][:n].astype(np.uint32) - 1)
    put("d2", np.where(uses_rs2,
                       3 * clk + 2 - s["ts2_prev"][:n].astype(np.uint32)
                       - 1, 0))
    put("d3", np.where(writes,
                       3 * clk + 3 - s["ts3_prev"][:n].astype(np.uint32)
                       - 1, 0))
    put("maddr_m", np.where(ls, s["mem_addr"][:n].astype(np.uint32), 0))
    put("wp", np.where(is_mem,
                       s["mem_prev_val"][:n].astype(np.uint32), 0))
    put("wn", np.where(is_mem, s["mem_new"][:n].astype(np.uint32), 0))
    put("mtsd", np.where(is_mem,
                         clk - s["mem_prev_ts"][:n].astype(np.uint32)
                         - 1, 0))
    clk0 = int(s["clk"][0]) if n else 1
    st_lo = lay.exit_code if static_lo is None else static_lo
    st_hi = lay.exit_code if static_hi is None else static_hi
    params = np.asarray([lay.program_start, lay.exit_code,
                         lay.heap_start, st_lo, st_hi, clk0, n],
                        np.uint32)
    return rows, params



# ---------------------------------------------------------------------------
# Plain PyTorch version (int64 arithmetic, 32-bit masks where uint32 wraps)
# ---------------------------------------------------------------------------

def _opset_table(ops, device) -> torch.Tensor:
    table = torch.zeros(256, dtype=torch.bool)
    for o in ops:
        table[int(o)] = True
    return table.to(device)


def _hist(idx_list, size: int) -> torch.Tensor:
    """Histogram over [0, size) of the stacked index tensors; the
    sentinel ``size`` (a masked emit) is dropped."""
    flat = torch.stack(idx_list).reshape(-1)
    return torch.bincount(flat, minlength=size + 1)[:size]


def cpu_fill_plain(rows: torch.Tensor, params):
    """(18, N) int32 step rows, 7 params -> ((193, N) int32 matrix in
    CPU_SCHEMA order, (N_HIST,) int32 histograms)."""
    dev = rows.device
    N = int(rows.shape[1])
    g = {name: rows[i].to(torch.int64) & _U32 for i, name in enumerate(_ROWS)}
    p = {name: int(v) for name, v in zip(_PARAMS, np.asarray(params))}
    n = p["n"]
    iota = torch.arange(N, dtype=torch.int64, device=dev)
    valid = iota < n
    # padding rows get an unused opcode id so no sel() matches
    opc = torch.where(valid, g["opcode"], 255)

    def sel(ops):
        if isinstance(ops, Opcode):
            ops = [ops]
        return _opset_table(ops, dev)[opc]

    def where(m, a, b=0):
        return torch.where(m, a, b).to(torch.int64)

    def b64(m):
        return m.to(torch.int64)

    f = {}

    def put(name, v, i=None):
        v = b64(v) if v.dtype == torch.bool else v
        if i is None:
            f[name] = v
        else:
            f.setdefault(name, [None] * CPU_SCHEMA.width(name))
            f[name][i] = v

    def bytes4(name, v):
        for i in range(4):
            put(name, (v >> (8 * i)) & 0xFF, i)

    def limbs(name, v):
        for i in range(4):
            put(name, (v >> (8 * i)) & (0xFF if i < 3 else 0x3F), i)

    # flags
    for op, i in _FLAG_IDX.items():
        put("f", sel(op), i)
    is_ecall = sel(Opcode.ECALL)
    b_val = g["b_val"]
    for name, code in SYS_FLAGS:
        put(name, is_ecall & (b_val == int(code)))
    s_halt = f["s_halt"].bool()
    put("pad", ~valid)

    # core scalars
    clk = where(valid, p["clk0"] + iota, 0)
    put("clk", clk)
    pc = where(valid, (p["prog_start"] + g["pc_rel"]) & _U32, 0)
    npc = where(valid, (p["prog_start"] + g["npc_rel"]) & _U32, 0)
    bytes4("pc", pc)
    bytes4("npc", npc)
    imm = g["imm"]
    bytes4("imm", imm)
    rd, rs1, rs2 = g["rd"], g["rs1"], g["rs2"]
    put("opa", where(is_ecall, 10, rd))
    put("opb", rs1)
    r_s_b = sel(_OPSETS["R_S_B"]) | is_ecall
    put("opc", where(r_s_b, rs2, 0))
    reg3 = where(is_ecall, where(f["s_sp"].bool(), 2, 10), rd)
    put("reg3", reg3)
    put("nz", reg3 != 0)
    put("inv_a", m31_inv(reg3))

    # values (already write/rs2-masked on the host)
    a_arr, c_arr = g["a_arr"], g["c_arr"]
    bytes4("a", a_arr)
    bytes4("b", b_val)
    bytes4("c", c_arr)
    a_prev = g["a_prev"]
    put("a_prev_lo", a_prev & 0xFFFF)
    put("a_prev_hi", a_prev >> 16)

    # register timestamps (host shipped the range-checked deltas)
    writes = sel(_WRITE_OPS) | (is_ecall & (
        f["s_write"] | f["s_priv"] | f["s_sp"] | f["s_hp"]).bool())
    uses_rs2 = r_s_b
    d1, d2, d3 = g["d1"], g["d2"], g["d3"]
    put("ts1p", where(valid, (3 * clk - d1) & _U32, 0))
    limbs("tsd1", d1)
    put("ts2p", where(uses_rs2, (3 * clk + 1 - d2) & _U32, 0))
    limbs("tsd2", d2)
    put("ts3p", where(writes, (3 * clk + 2 - d3) & _U32, 0))
    limbs("tsd3", d3)

    # carries
    b_lo, b_hi = b_val & 0xFFFF, b_val >> 16
    c_lo, c_hi = c_arr & 0xFFFF, c_arr >> 16
    pc_lo, pc_hi = pc & 0xFFFF, pc >> 16
    imm_lo, imm_hi = imm & 0xFFFF, imm >> 16
    ca1 = torch.zeros(N, dtype=torch.int64, device=dev)
    ca2 = torch.zeros(N, dtype=torch.int64, device=dev)
    m = sel([Opcode.ADD, Opcode.ADDI])
    ca1 = where(m, (b_lo + c_lo) >> 16, ca1)
    ca2 = where(m, (b_hi + c_hi + ca1) >> 16, ca2)
    m = sel(Opcode.SUB)
    ca1 = where(m, b64(b_lo < c_lo), ca1)
    ca2 = where(m, ((b_hi - c_hi - ca1) & _U32) >> 31, ca2)
    m = sel([Opcode.JAL, Opcode.JALR])
    ca1 = where(m, (pc_lo + 4) >> 16, ca1)
    ca2 = where(m, 0, ca2)
    m = sel(Opcode.AUIPC)
    ca1 = where(m, (pc_lo + imm_lo) >> 16, ca1)
    ca2 = where(m, (pc_hi + imm_hi + ca1) >> 16, ca2)
    is_load = sel(_LOADS)
    is_store = sel(_S_TYPE)
    ls = is_load | is_store
    raw_addr = where(ls, g["maddr_m"], where(s_halt, p["exit_code"], 0))
    bytes4("maddr", raw_addr)
    ca1 = where(ls, (b_lo + imm_lo) >> 16, ca1)
    ca2 = where(ls, ((b_hi + imm_hi + ca1) >> 16) & 1, ca2)
    put("carry_a", ca1, 0)
    put("carry_a", ca2, 1)

    # compare block
    cmp_on = sel(_CMP_OPS)
    br1 = where(cmp_on, b64(b_lo < c_lo), 0)
    h_lo_raw = (b_lo - c_lo + (br1 << 16)) & 0xFFFF
    br2 = where(cmp_on, ((b_hi - c_hi - br1) & _U32) >> 31, 0)
    h_hi_raw = (b_hi - c_hi - br1 + (br2 << 16)) & 0xFFFF
    h_lo = where(cmp_on, h_lo_raw, 0)
    h_hi = where(cmp_on, h_hi_raw, 0)
    put("br1", br1)
    put("br2", br2)
    put("h", h_lo & 0xFF, 0)
    put("h", h_lo >> 8, 1)
    put("h", h_hi & 0xFF, 2)
    put("h", h_hi >> 8, 3)
    e_lo = b64(h_lo == 0)
    e_hi = b64(h_hi == 0)
    put("e_lo", e_lo)
    put("e_hi", e_hi)
    put("i_lo", m31_inv(h_lo))
    put("i_hi", m31_inv(h_hi))
    sgn_on = sel(_SGN_OPS)
    b3 = (b_val >> 24) & 0xFF
    c3 = (c_arr >> 24) & 0xFF
    sgn_b = where(sgn_on, b3 >> 7, 0)
    sgn_c = where(cmp_on, c3 >> 7, 0)
    put("sgn_b", sgn_b)
    put("sgn_c", sgn_c)
    put("b3l7", where(sgn_on, b3 & 0x7F, 0))
    put("c3l7", where(cmp_on, c3 & 0x7F, 0))
    put("sgn_xor", sgn_b ^ sgn_c)

    # jalr lsb
    jalr = sel(Opcode.JALR)
    lsb = where(jalr, (b_val + imm) & 1, 0)
    put("lsb", lsb)

    # carry_pc (the reference's int32 arithmetic shifts; values are small
    # enough that int64 gives the same bits)
    eq = e_lo * e_hi
    lt_s = br2 ^ sgn_b ^ sgn_c
    T = (sel(Opcode.BEQ) & (eq == 1)) | (sel(Opcode.BNE) & (eq == 0)) \
        | (sel(Opcode.BLT) & (lt_s == 1)) \
        | (sel(Opcode.BGE) & (lt_s == 0)) \
        | (sel(Opcode.BLTU) & (br2 == 1)) \
        | (sel(Opcode.BGEU) & (br2 == 0)) \
        | sel(Opcode.JAL) | jalr
    base_lo = where(jalr, b_lo, pc_lo)
    base_hi = where(jalr, b_hi, pc_hi)
    lhs_lo = base_lo + where(T, imm_lo, 0) + where(T, 0, 4) \
        - where(s_halt, 4, 0) - lsb
    cp1 = (lhs_lo - (npc & 0xFFFF)) >> 16
    lhs_hi = base_hi + where(T, imm_hi, 0) + cp1
    cp2 = (lhs_hi - (npc >> 16)) >> 16
    put("carry_pc", cp1 & _U32, 0)
    put("carry_pc", cp2 & 1, 1)

    # shift block
    sll_on = sel(_SLL_OPS)
    shr_on = sel(_OPSETS["SHR"])
    sh_on = sll_on | shr_on
    c0 = c_arr & 0xFF
    put("c0q", where(sh_on, c0 >> 5, 0))
    sh5 = where(sh_on, c0 & 31, 0)
    q_idx = sh5 >> 3
    r = sh5 & 7
    put("sh_r", r)
    for k in range(4):
        put("q", sh_on & (q_idx == k), k)
    bb = [(b_val >> (8 * i)) & 0xFF for i in range(4)]
    sh_rem_cols = []
    for i in range(4):
        prod = bb[i] << r
        x = where(sll_on, prod >> 8, 0)
        y = where(sll_on, prod & 0xFF, 0)
        qv = bb[i] >> r
        x = where(shr_on, qv, x)
        rem = where(shr_on, bb[i] - (qv << r), 0)
        y = where(shr_on, (rem << (8 - r)) & 0xFF, y)
        put("sh_x", x, i)
        put("sh_y", y, i)
        put("sh_rem", rem, i)
        sh_rem_cols.append(rem)
    sra_on = sel(_SRA_OPS)
    put("sh_ph", where(sra_on, (1 << (8 - r)) >> 8, 0))
    put("sh_p", where(sra_on, (1 << (8 - r)) & 0xFF, 0))

    # memory block
    is_mem = ls | s_halt
    m0 = raw_addr & 0xFF
    mem_b = sel([Opcode.LB, Opcode.LBU, Opcode.SB])
    mem_h = sel([Opcode.LH, Opcode.LHU, Opcode.SH])
    put("mq", where(is_mem, m0 >> 2, 0))
    ofs = where(is_mem, m0 & 3, 0)
    put("mofs", ofs)
    for i in range(4):
        lane = mem_b & (ofs == i)
        if i in (0, 2):
            lane = lane | (mem_h & (ofs == i))
        put("l", lane, i)
    wp, wn = g["wp"], g["wn"]
    bytes4("wp", wp)
    bytes4("wn", wn)
    mtsd = g["mtsd"]
    put("mtsp", where(is_mem, (clk - 1 - mtsd) & _U32, 0))
    limbs("mtsd", mtsd)
    # load sign extraction
    lbh = sel([Opcode.LB, Opcode.LH])
    wp_bytes = [(wp >> (8 * i)) & 0xFF for i in range(4)]
    src_b = torch.zeros(N, dtype=torch.int64, device=dev)
    for i in range(4):
        src_b = where(ofs == i, wp_bytes[i], src_b)
    src_h_hi = where(ofs == 2, wp_bytes[3], wp_bytes[1])
    sign_src = where(sel(Opcode.LB), src_b,
                     where(sel(Opcode.LH), src_h_hi, 0))
    put("ld_s", where(lbh, sign_src >> 7, 0))
    put("ld_l7", where(lbh, sign_src & 0x7F, 0))
    # region decompositions
    exit_addr, heap = p["exit_code"], p["heap_start"]
    st_lo, st_hi = p["st_lo"], p["st_hi"]
    sm = is_store | s_halt
    above = raw_addr >= exit_addr
    st_sel = where(sm, b64(above), 0)
    srd = where(sm & above, (raw_addr - exit_addr) & _U32, 0)
    in_static = sm & ~above
    srd = where(in_static, (raw_addr - st_lo) & _U32, srd)
    srd2 = where(in_static, (st_hi - 1 - raw_addr) & _U32, 0)
    below = raw_addr < exit_addr
    ls_sel = where(is_load, b64(below), 0)
    srd = where(is_load & below, (exit_addr - 1 - raw_addr) & _U32, srd)
    srd = where(is_load & ~below, (raw_addr - heap) & _U32, srd)
    put("ls_sel", ls_sel)
    put("st_sel", st_sel)
    limbs("srd", srd)
    limbs("srd2", srd2)

    # bitwise nibble-high columns
    and_or = sel([Opcode.AND, Opcode.ANDI, Opcode.OR, Opcode.ORI])
    xor_on = sel([Opcode.XOR, Opcode.XORI])
    bw_on = and_or | xor_on
    cb = [(c_arr >> (8 * i)) & 0xFF for i in range(4)]
    ab = [(a_arr >> (8 * i)) & 0xFF for i in range(4)]
    for i in range(4):
        put("bh", where(bw_on, bb[i] >> 4, 0), i)
        put("ch", where(bw_on, cb[i] >> 4, 0), i)
        put("ah", where(bw_on, ab[i] >> 4, 0), i)

    # ---------------- assemble the schema matrix ----------------------
    cols = []
    for name, width in CPU_SCHEMA.spec:
        if width == 1:
            cols.append(f[name])
        else:
            assert all(v is not None for v in f[name]), name
            cols.extend(f[name])
    mat = torch.stack(cols)
    mat = torch.where(mat >= 1 << 31, mat - (1 << 32), mat).to(torch.int32)

    # ---------------- table histograms --------------------------------
    def col(name, i=0):
        return f[name][i] if isinstance(f[name], list) else f[name]

    def masked(idx, mask, rel):
        return where(mask, idx, RELATION_SIZES[rel])

    r256 = []
    for nm in ("a", "b", "c", "imm", "wp", "wn", "h"):
        r256 += [col(nm, i) for i in range(4)]
    for nm in ("pc", "npc", "maddr"):
        r256 += [col(nm, i) for i in range(3)]
    for nm in ("tsd1", "tsd2", "tsd3", "mtsd", "srd", "srd2"):
        r256 += [col(nm, i) for i in range(3)]
    r64 = [col(nm, 3) for nm in ("pc", "npc", "maddr", "tsd1", "tsd2",
                                 "tsd3", "mtsd", "srd", "srd2")]
    r64.append(col("mq"))
    r128 = [col("ld_l7"), col("b3l7"), col("c3l7")]
    r8 = [masked(col("c0q"), sh_on, "r8")]

    and4, xor4 = [], []
    for i in range(4):
        for part in (lambda v: v >> 4, lambda v: v & 0xF):
            and4.append(masked(part(bb[i]) * 16 + part(cb[i]), and_or,
                               "and4"))
            xor4.append(masked(part(bb[i]) * 16 + part(cb[i]), xor_on,
                               "xor4"))
    shl8, shr8 = [], []
    for i in range(4):
        shl8.append(masked(bb[i] * 9 + r, sll_on, "shl8"))
        shl8.append(masked(sh_rem_cols[i] * 9 + (8 - r), shr_on, "shl8"))
        shr8.append(masked(bb[i] * 8 + r, shr_on, "shr8"))
    shl8.append(masked(9 + 8 - r, sra_on, "shl8"))

    emits = {"r256": r256, "r64": r64, "r128": r128, "r8": r8,
             "and4": and4, "xor4": xor4, "shl8": shl8, "shr8": shr8}
    hist = torch.cat([_hist(emits[rel], size)
                      for rel, size in RELATION_SIZES.items()])
    return mat, hist.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel K5
# ---------------------------------------------------------------------------

def cpu_fill(rows: torch.Tensor, params):
    """(18, N) int32 step rows and the 7 params -> ((193, N) int32
    matrix, (N_HIST,) int32 histograms).  Launches ``csrc/fill.cu`` on a
    CUDA tensor; runs `cpu_fill_plain` on a CPU tensor."""
    if rows.is_cuda:
        kernels.check_cuda_tensor(rows, "step rows", ndim=2)
        if rows.shape[0] != len(_ROWS):
            raise ValueError(f"expected {len(_ROWS)} step rows, "
                             f"got {rows.shape[0]}")
        N = int(rows.shape[1])
        prm = [int(v) for v in np.asarray(params, np.uint32)]
        if len(prm) != len(_PARAMS) or prm[-1] > N:
            raise ValueError("bad fill params")
        mat = torch.empty((CPU_SCHEMA.n_cols, N), dtype=torch.int32,
                          device=rows.device)
        hist = torch.zeros(N_HIST, dtype=torch.int32, device=rows.device)
        kernels.launch("cpu_fill", rows.data_ptr(), N, *prm,
                       mat.data_ptr(), hist.data_ptr(), device=rows.device)
        return mat, hist
    if rows.device.type == "cpu":
        return cpu_fill_plain(rows, params)
    raise ValueError(f"unsupported device {rows.device}")


def cuda_header() -> str:
    """``fill_tables.cuh`` for ``csrc/fill.cu``: opcodes, syscall codes,
    the opcode sets as 256-bit masks, the flag column of each opcode,
    every column slot of CPU_SCHEMA and the histogram offsets, all taken
    from the Python tables."""
    out = ["// Generated by `python -m nexus_zkvm_tpu_torch.machine.fill_dev`"
           " from machine/cpu.py's tables; do not edit.",
           "#pragma once", "#include <cstdint>", "namespace fillgen {",
           f"constexpr int kCols = {CPU_SCHEMA.n_cols};",
           f"constexpr int kStepRows = {len(_ROWS)};",
           f"constexpr int kHist = {N_HIST};"]
    for op in Opcode:
        out.append(f"constexpr uint32_t OP_{op.name} = {int(op)}u;")
    for code in SyscallCode:
        out.append(f"constexpr uint32_t SYS_{code.name} = {int(code)}u;")
    for name, ops in _OPSETS.items():
        words = [0, 0, 0, 0]
        for o in ops:
            words[int(o) >> 6] |= 1 << (int(o) & 63)
        out.append(f"__constant__ uint64_t kSet_{name}[4] = {{"
                   + ", ".join(f"0x{w:016x}ull" for w in words) + "};")
    flag = [-1] * 256
    for op, i in _FLAG_IDX.items():
        flag[int(op)] = i
    out.append("__constant__ int8_t kFlag[256] = {"
               + ", ".join(str(v) for v in flag) + "};")
    out.append(f"constexpr int kNumFlags = {len(OP_FLAGS)};")
    out.append(f"constexpr int kNumSys = {len(SYS_FLAGS)};")
    out.append("__constant__ int kSysCol[kNumSys] = {"
               + ", ".join(str(CPU_SCHEMA.slot(nm)) for nm, _ in SYS_FLAGS)
               + "};")
    out.append("__constant__ uint32_t kSysCode[kNumSys] = {"
               + ", ".join(f"{int(c)}u" for _, c in SYS_FLAGS) + "};")
    for name, i in _RIDX.items():
        out.append(f"constexpr int R_{name} = {i};")
    for name, _w in CPU_SCHEMA.spec:
        out.append(f"constexpr int C_{name} = {CPU_SCHEMA.slot(name, 0)};")
    lo = 0
    for rel, size in RELATION_SIZES.items():
        out.append(f"constexpr int H_{rel} = {lo};")
        lo += size
    out.append("}  // namespace fillgen")
    return "\n".join(out) + "\n"


def fill_cpu_dev(trace, view, log_size: int, static_lo=None,
                 static_hi=None, device="cuda"):
    """CPU fill on ``device``: returns ((193, N) int32 matrix, (N_HIST,)
    int32 table histograms, relations in RELATION_SIZES order).  Matches
    `fill_cpu` + `count_multiplicity` bit for bit."""
    dev = resolve_device(device)
    rows, params = step_rows(trace, view, log_size, static_lo, static_hi)
    return cpu_fill(from_u32(rows, dev), params)


def step_rows(trace, view, log_size: int, static_lo=None, static_hi=None):
    """The (18, 2^log_size) uint32 step rows and the 7 params that
    `cpu_fill` takes, from a trace segment."""
    s = trace.steps
    n = len(s["clk"])
    unimpl = s["opcode"] == int(Opcode.UNIMPL)
    if unimpl.any():
        assert unimpl[np.argmax(unimpl):].all(), \
            "UNIMPL steps must be a trailing block"
        n = int(np.argmax(unimpl))
    N = 1 << log_size
    assert n <= N and log_size <= 28
    opc = s["opcode"][:n]
    present = set(np.unique(opc).tolist())
    supported = {int(o) for o in OP_FLAGS}
    assert present <= supported, \
        f"unsupported opcodes in trace: {present - supported}"
    return _host_prep(s, n, N, view, static_lo, static_hi)


if __name__ == "__main__":
    CUDA_HEADER.write_text(cuda_header())

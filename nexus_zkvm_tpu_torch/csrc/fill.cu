// K5: the CPU component's trace fill and its lookup-table histograms.
//
// Replaces the JAX package's device program nexus_zkvm_tpu/machine/
// fill_dev.py `_fill_body` (:143) with its histograms `_hist` (:124),
// stored and launched as `machine.fill_cpu_dev` (:494).
//
// In:  the (18, N) uint32 step rows of `_host_prep` (already masked and
//      delta-coded on the host) and the 7 params (program start, exit
//      address, heap start, static window, first clk, real rows n).
// Out: the (193, N) matrix in CPU_SCHEMA order and the histograms of
//      the eight table relations, one vector of 5,320 bins.
//
// One thread per row computes every column of that row, so the column-
// major stores of a warp are coalesced.  The same thread adds the row's
// table indices (about 100) into a per-block shared-memory histogram of
// all 5,320 bins (21 KB); each block walks many rows (grid-stride) and
// flushes its non-zero bins to device memory once with atomics, so the
// ~70 M indices of a 2^20 trace are never stored.  Integer counts are
// exact in any order.  Masked emits (the reference's sentinel index) are
// simply not added.
//
// What bounds it on the H100: device memory.  18 words are read and 193
// written per row (885 MB at 2^20 rows, 0.26 ms at 3.35 TB/s); the
// arithmetic (three M31 inverses by the ladder and some 600 bit
// operations per row) is under a fifth of that.
//
// Arithmetic follows the reference exactly: uint32_t where it relies on
// wraparound, int32_t where it shifts arithmetically (carry_pc).  The
// opcode sets, flag columns, column slots and relation offsets come from
// fill_tables.cuh, generated from machine/cpu.py's tables by
// machine/fill_dev.py `cuda_header`, never from literals here.
#include "m31.cuh"
#include "fill_tables.cuh"

using namespace fillgen;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool in_set(const uint64_t* m, uint32_t op) {
  return (m[op >> 6] >> (op & 63)) & 1ull;
}

struct Row {
  uint32_t* out;
  long long N, i;
  __device__ __forceinline__ void put(int col, uint32_t v) const {
    out[(long long)col * N + i] = v;
  }
  __device__ __forceinline__ void bytes4(int col, uint32_t v) const {
    for (int k = 0; k < 4; ++k) put(col + k, (v >> (8 * k)) & 0xFFu);
  }
  __device__ __forceinline__ void limbs(int col, uint32_t v) const {
    for (int k = 0; k < 4; ++k)
      put(col + k, (v >> (8 * k)) & (k < 3 ? 0xFFu : 0x3Fu));
  }
};

__device__ __forceinline__ void emit(uint32_t* sh, int base, uint32_t idx,
                                     uint32_t size) {
  if (idx < size) atomicAdd(&sh[base + idx], 1u);
}

// the three low bytes to r256 and the top limb (byte or 6-bit) to r64
__device__ __forceinline__ void emit_split(uint32_t* sh, uint32_t v,
                                           uint32_t top_mask) {
  for (int k = 0; k < 3; ++k) emit(sh, H_r256, (v >> (8 * k)) & 0xFFu, 256);
  emit(sh, H_r64, (v >> 24) & top_mask, 64);
}

struct Params {
  uint32_t prog_start, exit_code, heap_start, st_lo, st_hi, clk0, n;
};

__device__ void fill_row(const uint32_t* __restrict__ rows, const Params& p,
                         const Row& o, uint32_t* sh) {
  const long long N = o.N, i = o.i;
  auto g = [&](int r) { return __ldg(rows + (long long)r * N + i); };
  const bool valid = i < (long long)p.n;
  // padding rows get an unused opcode id so no set matches
  const uint32_t opc = valid ? g(R_opcode) : 255u;
  auto is = [&](uint32_t op) { return opc == op; };

  // flags
  const int flag = kFlag[opc];
  for (int k = 0; k < kNumFlags; ++k) o.put(C_f + k, k == flag);
  const bool is_ecall = is(OP_ECALL);
  const uint32_t b_val = g(R_b_val);
  for (int k = 0; k < kNumSys; ++k)
    o.put(kSysCol[k], is_ecall && b_val == kSysCode[k]);
  const bool s_halt = is_ecall && b_val == SYS_EXIT;
  const bool s_write = is_ecall && b_val == SYS_WRITE;
  const bool s_priv = is_ecall && b_val == SYS_READ_PRIVATE_INPUT;
  const bool s_sp = is_ecall && b_val == SYS_OVERWRITE_STACK_POINTER;
  const bool s_hp = is_ecall && b_val == SYS_OVERWRITE_HEAP_POINTER;
  o.put(C_pad, !valid);

  // core scalars
  const uint32_t clk = valid ? p.clk0 + (uint32_t)i : 0u;
  o.put(C_clk, clk);
  const uint32_t pc = valid ? p.prog_start + g(R_pc_rel) : 0u;
  const uint32_t npc = valid ? p.prog_start + g(R_npc_rel) : 0u;
  o.bytes4(C_pc, pc);
  o.bytes4(C_npc, npc);
  const uint32_t imm = g(R_imm);
  o.bytes4(C_imm, imm);
  const uint32_t rd = g(R_rd), rs1 = g(R_rs1), rs2 = g(R_rs2);
  o.put(C_opa, is_ecall ? 10u : rd);
  o.put(C_opb, rs1);
  const bool r_s_b = in_set(kSet_R_S_B, opc) || is_ecall;
  o.put(C_opc, r_s_b ? rs2 : 0u);
  const uint32_t reg3 = is_ecall ? (s_sp ? 2u : 10u) : rd;
  o.put(C_reg3, reg3);
  o.put(C_nz, reg3 != 0);
  o.put(C_inv_a, m31_inv(reg3));

  // values (already write/rs2-masked on the host)
  const uint32_t a_arr = g(R_a_arr), c_arr = g(R_c_arr);
  o.bytes4(C_a, a_arr);
  o.bytes4(C_b, b_val);
  o.bytes4(C_c, c_arr);
  const uint32_t a_prev = g(R_a_prev);
  o.put(C_a_prev_lo, a_prev & 0xFFFFu);
  o.put(C_a_prev_hi, a_prev >> 16);

  // register timestamps (the host shipped the range-checked deltas)
  const bool writes =
      in_set(kSet_WRITE, opc) || (is_ecall && (s_write || s_priv || s_sp || s_hp));
  const bool uses_rs2 = r_s_b;
  const uint32_t d1 = g(R_d1), d2 = g(R_d2), d3 = g(R_d3);
  o.put(C_ts1p, valid ? 3u * clk - d1 : 0u);
  o.limbs(C_tsd1, d1);
  o.put(C_ts2p, uses_rs2 ? 3u * clk + 1u - d2 : 0u);
  o.limbs(C_tsd2, d2);
  o.put(C_ts3p, writes ? 3u * clk + 2u - d3 : 0u);
  o.limbs(C_tsd3, d3);

  // carries
  const uint32_t b_lo = b_val & 0xFFFFu, b_hi = b_val >> 16;
  const uint32_t c_lo = c_arr & 0xFFFFu, c_hi = c_arr >> 16;
  const uint32_t pc_lo = pc & 0xFFFFu, pc_hi = pc >> 16;
  const uint32_t imm_lo = imm & 0xFFFFu, imm_hi = imm >> 16;
  uint32_t ca1 = 0, ca2 = 0;
  if (is(OP_ADD) || is(OP_ADDI)) {
    ca1 = (b_lo + c_lo) >> 16;
    ca2 = (b_hi + c_hi + ca1) >> 16;
  }
  if (is(OP_SUB)) {
    ca1 = b_lo < c_lo;
    ca2 = (b_hi - c_hi - ca1) >> 31;
  }
  if (is(OP_JAL) || is(OP_JALR)) {
    ca1 = (pc_lo + 4u) >> 16;
    ca2 = 0;
  }
  if (is(OP_AUIPC)) {
    ca1 = (pc_lo + imm_lo) >> 16;
    ca2 = (pc_hi + imm_hi + ca1) >> 16;
  }
  const bool is_load = in_set(kSet_LOADS, opc);
  const bool is_store = in_set(kSet_S_TYPE, opc);
  const bool ls = is_load || is_store;
  const uint32_t raw_addr = ls ? g(R_maddr_m) : (s_halt ? p.exit_code : 0u);
  o.bytes4(C_maddr, raw_addr);
  if (ls) {
    ca1 = (b_lo + imm_lo) >> 16;
    ca2 = ((b_hi + imm_hi + ca1) >> 16) & 1u;
  }
  o.put(C_carry_a, ca1);
  o.put(C_carry_a + 1, ca2);

  // compare block
  const bool cmp_on = in_set(kSet_CMP, opc);
  const uint32_t br1 = cmp_on ? (uint32_t)(b_lo < c_lo) : 0u;
  const uint32_t h_lo_raw = (b_lo - c_lo + (br1 << 16)) & 0xFFFFu;
  const uint32_t br2 = cmp_on ? (b_hi - c_hi - br1) >> 31 : 0u;
  const uint32_t h_hi_raw = (b_hi - c_hi - br1 + (br2 << 16)) & 0xFFFFu;
  const uint32_t h_lo = cmp_on ? h_lo_raw : 0u, h_hi = cmp_on ? h_hi_raw : 0u;
  o.put(C_br1, br1);
  o.put(C_br2, br2);
  const uint32_t h[4] = {h_lo & 0xFFu, h_lo >> 8, h_hi & 0xFFu, h_hi >> 8};
  for (int k = 0; k < 4; ++k) o.put(C_h + k, h[k]);
  const uint32_t e_lo = h_lo == 0, e_hi = h_hi == 0;
  o.put(C_e_lo, e_lo);
  o.put(C_e_hi, e_hi);
  o.put(C_i_lo, m31_inv(h_lo));
  o.put(C_i_hi, m31_inv(h_hi));
  const bool sgn_on = in_set(kSet_SGN, opc);
  const uint32_t b3 = (b_val >> 24) & 0xFFu, c3 = (c_arr >> 24) & 0xFFu;
  const uint32_t sgn_b = sgn_on ? b3 >> 7 : 0u, sgn_c = cmp_on ? c3 >> 7 : 0u;
  const uint32_t b3l7 = sgn_on ? b3 & 0x7Fu : 0u, c3l7 = cmp_on ? c3 & 0x7Fu : 0u;
  o.put(C_sgn_b, sgn_b);
  o.put(C_sgn_c, sgn_c);
  o.put(C_b3l7, b3l7);
  o.put(C_c3l7, c3l7);
  o.put(C_sgn_xor, sgn_b ^ sgn_c);

  // jalr lsb
  const bool jalr = is(OP_JALR);
  const uint32_t lsb = jalr ? (b_val + imm) & 1u : 0u;
  o.put(C_lsb, lsb);

  // carry_pc (int32 arithmetic shifts, as the reference)
  const uint32_t eq = e_lo * e_hi, lt_s = br2 ^ sgn_b ^ sgn_c;
  const bool T = (is(OP_BEQ) && eq == 1) || (is(OP_BNE) && eq == 0) ||
                 (is(OP_BLT) && lt_s == 1) || (is(OP_BGE) && lt_s == 0) ||
                 (is(OP_BLTU) && br2 == 1) || (is(OP_BGEU) && br2 == 0) ||
                 is(OP_JAL) || jalr;
  const int32_t base_lo = (int32_t)(jalr ? b_lo : pc_lo);
  const int32_t base_hi = (int32_t)(jalr ? b_hi : pc_hi);
  const int32_t lhs_lo = base_lo + (int32_t)(T ? imm_lo : 0u) + (T ? 0 : 4) -
                         (s_halt ? 4 : 0) - (int32_t)lsb;
  const int32_t cp1 = (lhs_lo - (int32_t)(npc & 0xFFFFu)) >> 16;
  const int32_t lhs_hi = base_hi + (int32_t)(T ? imm_hi : 0u) + cp1;
  const int32_t cp2 = (lhs_hi - (int32_t)(npc >> 16)) >> 16;
  o.put(C_carry_pc, (uint32_t)cp1);
  o.put(C_carry_pc + 1, (uint32_t)(cp2 & 1));

  // shift block
  const bool sll_on = in_set(kSet_SLL, opc), shr_on = in_set(kSet_SHR, opc);
  const bool sh_on = sll_on || shr_on, sra_on = in_set(kSet_SRA, opc);
  const uint32_t c0 = c_arr & 0xFFu;
  const uint32_t c0q = sh_on ? c0 >> 5 : 0u;
  o.put(C_c0q, c0q);
  const uint32_t sh5 = sh_on ? c0 & 31u : 0u;
  const uint32_t q_idx = sh5 >> 3, r = sh5 & 7u;
  o.put(C_sh_r, r);
  for (int k = 0; k < 4; ++k) o.put(C_q + k, sh_on && q_idx == (uint32_t)k);
  uint32_t bb[4], rem[4];
  for (int k = 0; k < 4; ++k) {
    bb[k] = (b_val >> (8 * k)) & 0xFFu;
    const uint32_t prod = bb[k] << r, qv = bb[k] >> r;
    uint32_t x = sll_on ? prod >> 8 : 0u, y = sll_on ? prod & 0xFFu : 0u;
    rem[k] = shr_on ? bb[k] - (qv << r) : 0u;
    if (shr_on) {
      x = qv;
      y = (rem[k] << (8u - r)) & 0xFFu;
    }
    o.put(C_sh_x + k, x);
    o.put(C_sh_y + k, y);
    o.put(C_sh_rem + k, rem[k]);
  }
  o.put(C_sh_ph, sra_on ? (1u << (8u - r)) >> 8 : 0u);
  o.put(C_sh_p, sra_on ? (1u << (8u - r)) & 0xFFu : 0u);

  // memory block
  const bool is_mem = ls || s_halt;
  const uint32_t m0 = raw_addr & 0xFFu;
  const bool mem_b = is(OP_LB) || is(OP_LBU) || is(OP_SB);
  const bool mem_h = is(OP_LH) || is(OP_LHU) || is(OP_SH);
  const uint32_t mq = is_mem ? m0 >> 2 : 0u, ofs = is_mem ? m0 & 3u : 0u;
  o.put(C_mq, mq);
  o.put(C_mofs, ofs);
  for (int k = 0; k < 4; ++k)
    o.put(C_l + k, (mem_b && ofs == (uint32_t)k) ||
                       ((k == 0 || k == 2) && mem_h && ofs == (uint32_t)k));
  const uint32_t wp = g(R_wp), wn = g(R_wn);
  o.bytes4(C_wp, wp);
  o.bytes4(C_wn, wn);
  const uint32_t mtsd = g(R_mtsd);
  o.put(C_mtsp, is_mem ? clk - 1u - mtsd : 0u);
  o.limbs(C_mtsd, mtsd);
  // load sign extraction
  const bool lb = is(OP_LB), lh = is(OP_LH), lbh = lb || lh;
  const uint32_t src_b = (wp >> (8 * ofs)) & 0xFFu;
  const uint32_t src_h_hi = (wp >> (ofs == 2 ? 24 : 8)) & 0xFFu;
  const uint32_t sign_src = lb ? src_b : (lh ? src_h_hi : 0u);
  const uint32_t ld_l7 = lbh ? sign_src & 0x7Fu : 0u;
  o.put(C_ld_s, lbh ? sign_src >> 7 : 0u);
  o.put(C_ld_l7, ld_l7);
  // region decompositions
  const bool sm = is_store || s_halt, above = raw_addr >= p.exit_code;
  uint32_t srd = (sm && above) ? raw_addr - p.exit_code : 0u;
  const bool in_static = sm && !above;
  if (in_static) srd = raw_addr - p.st_lo;
  const uint32_t srd2 = in_static ? p.st_hi - 1u - raw_addr : 0u;
  const bool below = raw_addr < p.exit_code;
  if (is_load && below) srd = p.exit_code - 1u - raw_addr;
  if (is_load && !below) srd = raw_addr - p.heap_start;
  o.put(C_ls_sel, is_load && below);
  o.put(C_st_sel, sm && above);
  o.limbs(C_srd, srd);
  o.limbs(C_srd2, srd2);

  // bitwise nibble-high columns
  const bool and_or = is(OP_AND) || is(OP_ANDI) || is(OP_OR) || is(OP_ORI);
  const bool xor_on = is(OP_XOR) || is(OP_XORI), bw_on = and_or || xor_on;
  for (int k = 0; k < 4; ++k) {
    const uint32_t cb = (c_arr >> (8 * k)) & 0xFFu, ab = (a_arr >> (8 * k)) & 0xFFu;
    o.put(C_bh + k, bw_on ? bb[k] >> 4 : 0u);
    o.put(C_ch + k, bw_on ? cb >> 4 : 0u);
    o.put(C_ah + k, bw_on ? ab >> 4 : 0u);
  }

  // ---------------- table histograms ----------------------------------
  // r256: every byte of a, b, c, imm, wp, wn, h; r256 + r64: the limbs
  // of pc, npc, maddr (byte tops) and of the 8/8/8/6 deltas
  const uint32_t full[6] = {a_arr, b_val, c_arr, imm, wp, wn};
  for (int v = 0; v < 6; ++v)
    for (int k = 0; k < 4; ++k) emit(sh, H_r256, (full[v] >> (8 * k)) & 0xFFu, 256);
  for (int k = 0; k < 4; ++k) emit(sh, H_r256, h[k], 256);
  emit_split(sh, pc, 0xFFu);
  emit_split(sh, npc, 0xFFu);
  emit_split(sh, raw_addr, 0xFFu);
  const uint32_t deltas[6] = {d1, d2, d3, mtsd, srd, srd2};
  for (int v = 0; v < 6; ++v) emit_split(sh, deltas[v], 0x3Fu);
  emit(sh, H_r64, mq, 64);
  emit(sh, H_r128, ld_l7, 128);
  emit(sh, H_r128, b3l7, 128);
  emit(sh, H_r128, c3l7, 128);
  if (sh_on) emit(sh, H_r8, c0q, 8);
  for (int k = 0; k < 4; ++k) {
    const uint32_t cb = (c_arr >> (8 * k)) & 0xFFu;
    const uint32_t hi = (bb[k] >> 4) * 16u + (cb >> 4);
    const uint32_t lo = (bb[k] & 0xFu) * 16u + (cb & 0xFu);
    if (and_or) {
      emit(sh, H_and4, hi, 256);
      emit(sh, H_and4, lo, 256);
    }
    if (xor_on) {
      emit(sh, H_xor4, hi, 256);
      emit(sh, H_xor4, lo, 256);
    }
    if (sll_on) emit(sh, H_shl8, bb[k] * 9u + r, 9 * 256);
    if (shr_on) {
      emit(sh, H_shl8, rem[k] * 9u + (8u - r), 9 * 256);
      emit(sh, H_shr8, bb[k] * 8u + r, 8 * 256);
    }
  }
  if (sra_on) emit(sh, H_shl8, 9u + 8u - r, 9 * 256);
}

__global__ void __launch_bounds__(kThreads)
cpu_fill(const uint32_t* __restrict__ rows, long long N, Params p,
         uint32_t* __restrict__ out, uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[kHist];
  for (int k = threadIdx.x; k < kHist; k += blockDim.x) sh[k] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long long)gridDim.x * blockDim.x)
    fill_row(rows, p, Row{out, N, i}, sh);
  __syncthreads();
  for (int k = threadIdx.x; k < kHist; k += blockDim.x)
    if (sh[k]) atomicAdd(&hist[k], sh[k]);
}

}  // namespace

// rows (18, N), out (193, N), hist (5,320) zeroed by the caller.
extern "C" int nzt_cpu_fill(const uint32_t* rows, long long N,
                            uint32_t prog_start, uint32_t exit_code,
                            uint32_t heap_start, uint32_t st_lo,
                            uint32_t st_hi, uint32_t clk0, uint32_t n,
                            uint32_t* out, uint32_t* hist, void* stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  if (blocks < 1) blocks = 1;
  cpu_fill<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, N, Params{prog_start, exit_code, heap_start, st_lo, st_hi, clk0, n},
      out, hist);
  return (int)cudaGetLastError();
}

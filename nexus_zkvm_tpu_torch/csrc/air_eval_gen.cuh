// K7: a component's constraint tape over the rows of its domain, as
// straight-line code generated from the tape.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/air/
// component.py `run_constraints_domain` (:601, launched from
// `_composition_coeffs_fused` prover/stark.py:364 through aot_call :484),
// its row-chunked form `run_constraints_domain_chunked` (:739, aot_call
// :780, the `domscan` program, with `ChunkedDomainEvalContext` :641) and
// the evaluate() part of `_gen_interaction_body` (:346, launched through
// `generate_interaction` :407).  Each runs a component's evaluate() over
// rows of its domain.  Here evaluate() has been recorded once on the host
// as an M31 program (nexus_zkvm_tpu_torch/air/tape.py), and
// nexus_zkvm_tpu_torch/air/tape_cuda.py writes that program out as C++:
// one statement per row operation, in the tape's depth-first order, into
// a source file that defines NZT_COMPOSE, NZT_STRIDE and NZT_NU, includes
// this template and then defines
//
//   __device__ __forceinline__ void nzt_tape_body(const NztRow& r,
//                                                 NztAcc& acc);
//
// Every row value is a local uint32_t (registers).  A load (role, column,
// offset) is LD(role, col, off) with literal column and offset, an
// ld.global.nc the compiler may neither merge with another nor hoist
// above an earlier one, so that a word read all along a tape does not
// hold a register all along (the generator keeps it in a variable for the
// uses that follow closely and loads it again later); a constant is a
// literal; a value derived from the challenges is U(k), a word of the
// piece's uniform table in constant memory (the same for every thread, so
// an operand of the instruction, no load).  Constraint j adds w_j * c_j to
// the accumulator, w_j = alpha^(K-1-j) four table words (EMIT1: an M31
// constraint, four products; EMITQ: a QM31 one); the accumulator keeps
// four unreduced 64-bit sums, folded (FOLD) after every third constraint
// and reduced once in the epilogue.  A LogUp operand is stored by ST(a, b,
// step, x) at word a * M + b + step * row of K6's packed buffer, M the
// launch's rows and row counted from its first (step 0: a word shared by
// every row, written by row 0 only).  A large tape is cut
// by output range into pieces, each its own kernel and library; each
// piece recomputes the values it shares with others, and the wrapper
// launches them in turn on one stream.
//
// Two epilogues, chosen by NZT_COMPOSE:
//   composition (1): rows [lo, lo + L) of the 4x domain, bucket[row] +=
//     acc * invv[row] * shift (QM31; bucket and invv are the whole
//     domain's, the bucket the (N, 4) sum of every component of this eval
//     size; a piece adds its own part, and the bucket's words equal the
//     one-piece sum since the composition is linear in the constraints).
//     The columns are halo-extended natural blocks: position q of a block
//     holds natural row lo - hneg + q (mod N), so the thread of row lo + t
//     reads position t + hneg + off * NZT_STRIDE with no wrap;
//   operands (0): rows [0, L) of the trace, or of a mesh rank's window of
//     it.  Whole (L = N): loads read the trace's own columns at (row +
//     off) mod N, N a power of two (the wrap is the roll of the
//     reference; mask N - 1).  A window: halo-extended blocks as above,
//     position q holding window row q - hneg, every load inside them
//     (mask -1: no wrap).  Either way the packed buffer is laid out for
//     the L rows of the launch.
//
// What bounds it on the H100: the operations of the composition (an M31
// product counts 6, an add 3; chip_smoke.py `tape_cost`), the bytes of
// the operands (the columns read once, the packed buffer written once).
// The design keeps the decode out of the row loop: no opcode switch, no
// operand-kind decode, no shared-memory slots, no address table, so what
// a row executes is its field operations, its loads (consecutive rows of
// one column for consecutive threads: coalesced) and the epilogue.  The
// field operations take canonical operands and give canonical results
// with one fold and one unsigned min each (nzt_mul: a product below
// (p - 1)^2 < 2^62 folds once to at most 2p - 3), and a piece keeps at
// most 96 values alive (air/tape_cuda.py PIECE_LIVE) so that they fit the
// 128 registers of four blocks an SM.
#pragma once

#ifdef NZT_HOST
#include "host_shim.h"
#endif
#include "m31.cuh"

#if !defined(NZT_COMPOSE) || !defined(NZT_STRIDE) || !defined(NZT_NU)
#error "a generated tape source defines NZT_COMPOSE, NZT_STRIDE and NZT_NU"
#endif

// 128 threads a block and at most 128 registers a thread: four blocks an
// SM
#define NZT_THREADS 128
#define NZT_MIN_BLOCKS 4

namespace {

__constant__ uint32_t kU[NZT_NU > 0 ? NZT_NU : 1];

// one launch: role -> its matrix (rows of W words), the rows it runs
struct NztLaunch {
  const uint32_t* base[4];
  uint32_t W;
  long long lo, L, hneg;
  long long mask;     // operands: N - 1 (the whole trace) or -1 (a window)
  long long M;        // operands: the launch's rows (store words a * M + b)
  qm31 shift;
  const uint32_t* invv;
  uint32_t* bucket;
  uint32_t* out;
};

// one row: role -> its column 0 at this row's position (composition) or
// at position hneg (operands)
struct NztRow {
  const uint32_t* p[4];
  uint32_t W;
  long long t, row, mask, M;
  uint32_t* out;
};

__device__ __forceinline__ void nzt_store(const NztRow& r, long long a,
                                          long long b, int step,
                                          uint32_t x) {
  if (step != 0)
    r.out[a * r.M + b + (long long)step * r.row] = x;
  else if (r.row == 0)
    r.out[a * r.M + b] = x;
}

__device__ __forceinline__ qm31 nzt_weight(int k) {
  return {kU[k], kU[k + 1], kU[k + 2], kU[k + 3]};
}

__device__ __forceinline__ uint32_t nzt_ld(const uint32_t* p) {
#ifdef NZT_HOST
  return *p;
#else
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
#endif
}

// M31 on canonical operands, canonical results
__device__ __forceinline__ uint32_t nzt_umin(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t nzt_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return nzt_umin(s, s - NZT_P);
}

__device__ __forceinline__ uint32_t nzt_sub(uint32_t a, uint32_t b) {
  const uint32_t d = a + (NZT_P - b);
  return nzt_umin(d, d - NZT_P);
}

__device__ __forceinline__ uint32_t nzt_neg(uint32_t a) {
  return nzt_umin(NZT_P - a, 0u - a);
}

__device__ __forceinline__ uint32_t nzt_mul(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t r = (uint32_t)(t >> 31) + ((uint32_t)t & NZT_P);
  return nzt_umin(r, r - NZT_P);
}

__device__ __forceinline__ cm31 nzt_cmul(cm31 x, cm31 y) {
  return {nzt_sub(nzt_mul(x.a, y.a), nzt_mul(x.b, y.b)),
          nzt_add(nzt_mul(x.a, y.b), nzt_mul(x.b, y.a))};
}

// (A + B u)(C + D u) = AC + R BD + (AD + BC) u, R = 2 + i
__device__ __forceinline__ qm31 nzt_qmul(qm31 x, qm31 y) {
  const cm31 xa = {x.a, x.b}, xb = {x.c, x.d}, ya = {y.a, y.b},
             yb = {y.c, y.d};
  const cm31 ac = nzt_cmul(xa, ya), bd = nzt_cmul(xb, yb),
             ad = nzt_cmul(xa, yb), bc = nzt_cmul(xb, ya);
  return {nzt_add(ac.a, nzt_sub(nzt_add(bd.a, bd.a), bd.b)),
          nzt_add(ac.b, nzt_add(nzt_add(bd.b, bd.b), bd.a)),
          nzt_add(ad.a, bc.a), nzt_add(ad.b, bc.b)};
}

}  // namespace

// the constraints' sum: four 64-bit coordinates, each below 2^34 after a
// fold; three constraints add less than 3 * 2^62 before the next
struct NztAcc {
  uint64_t a, b, c, d;
};

namespace {

__device__ __forceinline__ void nzt_emit1(NztAcc& acc, int k, uint32_t x) {
  acc.a += (uint64_t)kU[k] * x;
  acc.b += (uint64_t)kU[k + 1] * x;
  acc.c += (uint64_t)kU[k + 2] * x;
  acc.d += (uint64_t)kU[k + 3] * x;
}

__device__ __forceinline__ void nzt_emitq(NztAcc& acc, int k, qm31 e) {
  const qm31 v = nzt_qmul(nzt_weight(k), e);
  acc.a += v.a;
  acc.b += v.b;
  acc.c += v.c;
  acc.d += v.d;
}

__device__ __forceinline__ uint64_t nzt_fold(uint64_t t) {
  return (t & NZT_P) + (t >> 31);
}

}  // namespace

#if NZT_COMPOSE
#define LD(role, col, off) \
  nzt_ld(r.p[role] + (unsigned long long)r.W * (col) + (off) * NZT_STRIDE)
#else
#define LD(role, col, off)                           \
  nzt_ld(r.p[role] + (unsigned long long)r.W * (col) + \
         ((r.t + (off) * NZT_STRIDE) & r.mask))
#endif
#define U(k) kU[k]
#define EMIT1(k, x) nzt_emit1(acc, (k), (x))
#define EMITQ(k, a, b, c, d) nzt_emitq(acc, (k), qm31{(a), (b), (c), (d)})
#define FOLD()                 \
  acc = {nzt_fold(acc.a), nzt_fold(acc.b), nzt_fold(acc.c), \
         nzt_fold(acc.d)}
#define ST(a, b, step, x) nzt_store(r, (a), (b), (step), (x))

__device__ __forceinline__ void nzt_tape_body(const NztRow& r, NztAcc& acc);

namespace {

__device__ __forceinline__ void nzt_tape_row(const NztLaunch& a,
                                             long long t) {
  NztRow r;
  const long long at = NZT_COMPOSE ? t + a.hneg : a.hneg;
  for (int k = 0; k < 4; ++k) r.p[k] = a.base[k] + at;
  r.W = a.W;
  r.t = t;
  r.row = a.lo + t;
  r.mask = a.mask;
  r.M = a.M;
  r.out = a.out;
  NztAcc acc = {0u, 0u, 0u, 0u};
  nzt_tape_body(r, acc);
#if NZT_COMPOSE
  const qm31 sum = {m31_reduce64(acc.a), m31_reduce64(acc.b),
                    m31_reduce64(acc.c), m31_reduce64(acc.d)};
  const qm31 d = qm31_mul(qm31_mul_m31(sum, __ldg(a.invv + r.row)), a.shift);
  uint32_t* b = a.bucket + 4 * r.row;
  qm31_store(b, qm31_add(qm31_load(b), d));
#endif
}

#ifndef NZT_HOST
__global__ void __launch_bounds__(NZT_THREADS, NZT_MIN_BLOCKS)
    nzt_tape_kernel(const NztLaunch a) {
  const long long t = (long long)blockIdx.x * NZT_THREADS + threadIdx.x;
  if (t < a.L) nzt_tape_row(a, t);
}
#endif

// copy the piece's uniform words (device memory on the card, host memory
// under NZT_HOST) into kU, then run rows [0, L) of the launch
int nzt_run(const NztLaunch& a, const uint32_t* uni, void* stream) {
  if (a.L <= 0 || a.lo < 0 || a.hneg < 0) return 1;  // cudaErrorInvalidValue
#ifdef NZT_HOST
  (void)stream;
  if (NZT_NU > 0) std::memcpy(kU, uni, sizeof(uint32_t) * NZT_NU);
  for (long long t = 0; t < a.L; ++t) nzt_tape_row(a, t);
  return 0;
#else
  cudaStream_t st = (cudaStream_t)stream;
  if (NZT_NU > 0) {
    cudaError_t e = cudaMemcpyToSymbolAsync(kU, uni,
                                            sizeof(uint32_t) * NZT_NU, 0,
                                            cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (a.L + NZT_THREADS - 1) / NZT_THREADS;
  nzt_tape_kernel<<<(unsigned)blocks, NZT_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
#endif
}

}  // namespace

#if NZT_COMPOSE
// rows [lo, lo + L) of the N-row domain; b0..b3 the roles' halo-extended
// blocks (rows of W words); shift QM31 words; invv (N,) and bucket (N, 4),
// added to; uni the piece's uniform words
extern "C" int nzt_tape_entry(const uint32_t* b0, const uint32_t* b1,
                              const uint32_t* b2, const uint32_t* b3,
                              long long W, long long lo, long long L,
                              long long hneg, uint32_t s0, uint32_t s1,
                              uint32_t s2, uint32_t s3, const uint32_t* invv,
                              uint32_t* bucket, const uint32_t* uni,
                              void* stream) {
  NztLaunch a = {{b0, b1, b2, b3}, (uint32_t)W, lo, L, hneg, -1LL, 0,
                 {s0, s1, s2, s3}, invv, bucket, nullptr};
  return nzt_run(a, uni, stream);
}
#else
// rows [0, L); b0..b3 the roles' columns (rows of W words): the whole
// trace (W = L = N, hneg 0, mask N - 1) or a window's halo-extended blocks
// (mask -1); out K6's packed operand buffer for L rows
extern "C" int nzt_tape_entry(const uint32_t* b0, const uint32_t* b1,
                              const uint32_t* b2, const uint32_t* b3,
                              long long W, long long L, long long hneg,
                              long long mask, uint32_t* out,
                              const uint32_t* uni, void* stream) {
  NztLaunch a = {{b0, b1, b2, b3}, (uint32_t)W, 0, L, hneg, mask, L,
                 {0u, 0u, 0u, 0u}, nullptr, nullptr, out};
  return nzt_run(a, uni, stream);
}
#endif

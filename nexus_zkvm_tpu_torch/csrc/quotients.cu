// K3: DEEP quotient accumulation over one committed size group.
//
// Replaces the JAX package's device program nexus_zkvm_tpu/ops/quotients.py
// `_accumulate_blocks` (:157), run as `stark.quotients2`
// (nexus_zkvm_tpu/prover/stark.py:1013), and covers its gather variant
// `_accumulate_raw` (:125).
//
// One thread per domain point p (committed order):
//   for every column k of every role block, v = col_k(p), and for every
//   sample s with a non-zero coefficient: acc[s] += gcs[s][k] * v,
//   each product reduced to M31 and summed exactly in uint64;
//   then per sample: V = dy (x_p - z_x) - dx (y_p - z_y), num =
//   fold(acc[s]) - A y_p - B, total += num * V^-1 (QM31 inverse by the
//   x^(p-2) ladder in registers).
// The role blocks (pre, main, inter, comp) arrive as separate matrices,
// so no (K, M) gather is ever built.  The coefficients and per-sample
// constants are the same for every thread and are read through the
// read-only cache as broadcasts.
//
// What bounds it on the H100: one read of the (K, M) evaluations
// (4 K M bytes, coalesced: neighbouring threads read neighbouring
// points) and the multiply-accumulates, one widening multiply and a
// fold per (sample, column, coordinate) that takes part.  Zero
// coefficients (a column absent from a sample) are skipped, a uniform
// branch across the warp.
#include "m31.cuh"

#define NZT_MAX_SAMPLES 8

namespace {

__global__ void deep_quotients(const uint32_t* b0, const uint32_t* b1,
                               const uint32_t* b2, const uint32_t* b3, int n0,
                               int n1, int n2, int n3,
                               const uint32_t* __restrict__ xs,
                               const uint32_t* __restrict__ ys,
                               const uint32_t* __restrict__ consts,
                               const uint32_t* __restrict__ gcs, int S, int K,
                               long long M, uint32_t* __restrict__ out) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  uint64_t acc[NZT_MAX_SAMPLES][4];
#pragma unroll
  for (int s = 0; s < NZT_MAX_SAMPLES; ++s)
    acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0;

  const uint32_t* blocks[4] = {b0, b1, b2, b3};
  const int rows[4] = {n0, n1, n2, n3};
  int k = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t* blk = blocks[r];
    for (int i = 0; i < rows[r]; ++i, ++k) {
      uint32_t v = __ldg(blk + (long long)i * M + p);
#pragma unroll
      for (int s = 0; s < NZT_MAX_SAMPLES; ++s) {
        if (s >= S) break;
        uint4 g = __ldg(reinterpret_cast<const uint4*>(
            gcs + ((long long)s * K + k) * 4));
        if ((g.x | g.y | g.z | g.w) == 0u) continue;
        acc[s][0] += m31_mul(g.x, v);
        acc[s][1] += m31_mul(g.y, v);
        acc[s][2] += m31_mul(g.z, v);
        acc[s][3] += m31_mul(g.w, v);
      }
    }
  }

  uint32_t x = __ldg(xs + p), y = __ldg(ys + p);
  qm31 total = {0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < NZT_MAX_SAMPLES; ++s) {
    if (s >= S) break;
    const uint32_t* c = consts + s * 24;   // zx, zy, dx, dy, A, B
    qm31 zx = qm31_load(c), zy = qm31_load(c + 4), dx = qm31_load(c + 8);
    qm31 dy = qm31_load(c + 12), A = qm31_load(c + 16), B = qm31_load(c + 20);
    qm31 vx = qm31_sub({x, 0, 0, 0}, zx);
    qm31 vy = qm31_sub({y, 0, 0, 0}, zy);
    qm31 V = qm31_sub(qm31_mul(dy, vx), qm31_mul(dx, vy));
    qm31 num = {m31_reduce64(acc[s][0]), m31_reduce64(acc[s][1]),
                m31_reduce64(acc[s][2]), m31_reduce64(acc[s][3])};
    num = qm31_sub(qm31_sub(num, qm31_mul_m31(A, y)), B);
    total = qm31_add(total, qm31_mul(num, qm31_inv(V)));
  }
  qm31_store(out + p * 4, total);
}

constexpr int kThreads = 128;

}  // namespace

// blocks b0..b3 with n0..n3 rows of M committed-order evaluations
// (unused blocks have 0 rows); consts (S, 6, 4); gcs (S, K, 4) with
// K = n0 + n1 + n2 + n3; out (M, 4).
extern "C" int nzt_deep_quotients(const uint32_t* b0, const uint32_t* b1,
                                  const uint32_t* b2, const uint32_t* b3,
                                  int n0, int n1, int n2, int n3,
                                  const uint32_t* xs, const uint32_t* ys,
                                  const uint32_t* consts, const uint32_t* gcs,
                                  int S, int K, long long M, uint32_t* out,
                                  void* stream) {
  if (S < 1 || S > NZT_MAX_SAMPLES || n0 + n1 + n2 + n3 != K)
    return (int)cudaErrorInvalidValue;
  long long blocks = (M + kThreads - 1) / kThreads;
  deep_quotients<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b0, b1, b2, b3, n0, n1, n2, n3, xs, ys, consts, gcs, S, K, M, out);
  return (int)cudaGetLastError();
}

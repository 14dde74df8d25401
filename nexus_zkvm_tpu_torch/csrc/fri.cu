// K4: FRI fold of a QM31 layer, with the optional injection of a smaller
// input on the landing fold of a block.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/ops/fri.py
// `_fold_body` (:209), stored as `fri.fold` (:222), and the block program
// `fri.blockfold` (:342), which chains a block's k folds and the
// injection w^2 * cur + fold(inj, w).
//
// One thread per output element i of a (2L, 4) -> (L, 4) fold:
//   (a, b) = (in[2i], in[2i + 1]),  out[i] = (a + b) + alpha (a - b) t[i]
// and with an injected input on the landing fold:
//   out[i] = w2 * out[i] + (inj[2i] + inj[2i + 1])
//            + alpha (inj[2i] - inj[2i + 1]) t_inj[i].
// A block of k folds is k launches (alpha^(2^i) computed on the host).
//
// What bounds it on the H100: device memory, 32 bytes read and 16 bytes
// written per output (plus the twiddle), all as 16-byte vector accesses;
// one QM31 product (12 M31 multiplies) per output is far below the ALU
// limit.  Fusing a block's k folds into one launch (a block keeping its
// 2^k-coset in registers) would cut the intermediate layers' traffic and
// is left for later.
#include "m31.cuh"

namespace {

__device__ __forceinline__ qm31 fold_pair(const uint32_t* src, long long i,
                                          qm31 alpha, uint32_t t) {
  qm31 a = qm31_load(src + 8 * i), b = qm31_load(src + 8 * i + 4);
  return qm31_add(qm31_add(a, b), qm31_mul(alpha, qm31_mul_m31(qm31_sub(a, b), t)));
}

__global__ void fri_fold(const uint32_t* __restrict__ src,
                         uint32_t* __restrict__ dst, long long L,
                         const uint32_t* __restrict__ tw, qm31 alpha,
                         const uint32_t* __restrict__ inj,
                         const uint32_t* __restrict__ inj_tw, qm31 w2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  qm31 v = fold_pair(src, i, alpha, __ldg(tw + i));
  if (inj != nullptr)
    v = qm31_add(qm31_mul(w2, v), fold_pair(inj, i, alpha, __ldg(inj_tw + i)));
  qm31_store(dst + 4 * i, v);
}

constexpr int kThreads = 256;

}  // namespace

// src (2L, 4), dst (L, 4), tw (L,), alpha = (a0..a3); inj (2L, 4) and
// inj_tw (L,) may be null, otherwise w2 = (w0..w3) scales the fold of src.
extern "C" int nzt_fri_fold(const uint32_t* src, uint32_t* dst, long long L,
                            const uint32_t* tw, uint32_t a0, uint32_t a1,
                            uint32_t a2, uint32_t a3, const uint32_t* inj,
                            const uint32_t* inj_tw, uint32_t w0, uint32_t w1,
                            uint32_t w2, uint32_t w3, void* stream) {
  long long blocks = (L + kThreads - 1) / kThreads;
  fri_fold<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, L, tw, qm31{a0, a1, a2, a3}, inj, inj_tw, qm31{w0, w1, w2, w3});
  return (int)cudaGetLastError();
}

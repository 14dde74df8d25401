// K8: out-of-domain samples of coefficient rows at a QM31 point.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/prover/
// stark.py `_oods_dot` (:176, body `_oods_dot_body` :167) and
// `_oods_dot_factored` (:197): for C rows of bit-reversed circle
// coefficients cols (C, N), N = 2^n,
//   out[c] = sum_j cols[c, j] * basis[j]              (QM31)
// where basis[j] is the product of the point's factors f_i over the set
// bits i of j (the Kron basis, `_oods_basis_factors` :180).  The basis is
// never formed: with j = lo + 2^k hi,
//   basis[j] = B_lo[lo] * B_hi[hi],
//   out[c]   = sum_hi B_hi[hi] * (sum_lo cols[c, lo + 2^k hi] * B_lo[lo]),
// B_lo over the k low factors (2^k entries, k <= 11) and B_hi over the
// rest, both formed in the kernel from the factors (the only host input
// besides the rows).  The inner sums are M31 x QM31: four M31
// products an element, added into four uint64 accumulators (each term is
// reduced, so 2^33 of them cannot overflow) and reduced once per hi; then
// one QM31 product with B_hi[hi] per hi and thread.
//
// Thread t of a 256-thread block owns the fixed lo set {t, t + 256, ...}
// (at most 8 entries) and keeps its B_lo values in registers; a block
// walks a range of at most 256 hi for one row c (reads of consecutive lo
// coalesce), with that range's B_hi in shared memory, reduces its
// threads' QM31 totals through warp shuffles and shared memory, and
// writes one partial.
// A second pass adds the G partials of each row.
//
// What bounds it on the H100: the bytes for the big groups (every
// coefficient word read once: 4 bytes against 4 products and adds, ~36
// operations, under the card's 10 operations a byte at the issue limit),
// the operations where C is small.
#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;        // lo entries a thread owns: 2^k <= 2048
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ qm31 shfl_down(qm31 v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.a, d), __shfl_down_sync(0xffffffffu, v.b, d),
          __shfl_down_sync(0xffffffffu, v.c, d), __shfl_down_sync(0xffffffffu, v.d, d)};
}

// the product of f[b] over the set bits b < nbits of idx
__device__ __forceinline__ qm31 kron(const uint32_t* __restrict__ f, int idx,
                                     int nbits) {
  qm31 acc = {1u, 0u, 0u, 0u};
  for (int b = 0; b < nbits; ++b)
    if ((idx >> b) & 1) acc = qm31_mul(acc, qm31_load(f + 4 * b));
  return acc;
}

// grid (G, C): block g of row c takes hi in [g * per_block, ...),
// per_block <= kThreads
__global__ void __launch_bounds__(kThreads)
oods_partial(const uint32_t* __restrict__ cols, int log_n, int k,
             const uint32_t* __restrict__ factors, int per_block,
             uint32_t* __restrict__ partial) {
  __shared__ qm31 bhi[kThreads];
  __shared__ qm31 warp_tot[kWarps];
  const int c = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int nlo = 1 << k, nhi = 1 << (log_n - k);
  const int h0 = g * per_block, h1 = min(nhi, h0 + per_block);
  // B_hi over this block's hi range, from the high factors
  if (h0 + (int)threadIdx.x < h1)
    bhi[threadIdx.x] = kron(factors + 4 * k, h0 + threadIdx.x, log_n - k);
  // B_lo[t + 256 i] = (low-8-bit factors over t) * (the rest over i)
  const int lo8 = min(k, 8);
  const qm31 pt = kron(factors, threadIdx.x, lo8);
  qm31 b[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int lo = threadIdx.x + i * kThreads;
    b[i] = lo < nlo ? qm31_mul(pt, kron(factors + 4 * lo8, i, k - lo8))
                    : qm31{0u, 0u, 0u, 0u};
  }
  __syncthreads();
  const uint32_t* row = cols + ((long long)c << log_n);
  qm31 total = {0u, 0u, 0u, 0u};
  for (int hi = h0; hi < h1; ++hi) {
    const uint32_t* seg = row + ((long long)hi << k);
    uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int lo = threadIdx.x + i * kThreads;
      if (lo < nlo) {
        const uint32_t x = __ldg(seg + lo);
        s0 += m31_mul(x, b[i].a);
        s1 += m31_mul(x, b[i].b);
        s2 += m31_mul(x, b[i].c);
        s3 += m31_mul(x, b[i].d);
      }
    }
    const qm31 inner = {m31_reduce64(s0), m31_reduce64(s1), m31_reduce64(s2),
                        m31_reduce64(s3)};
    total = qm31_add(total, qm31_mul(inner, bhi[hi - h0]));
  }
  for (int d = 16; d > 0; d >>= 1) total = qm31_add(total, shfl_down(total, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    qm31 s = warp_tot[0];
    for (int w = 1; w < kWarps; ++w) s = qm31_add(s, warp_tot[w]);
    qm31_store(partial + 4 * ((long long)c * G + g), s);
  }
}

// one thread a row: the sum of its G partials
__global__ void oods_finish(const uint32_t* __restrict__ partial, int C, int G,
                            uint32_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  qm31 s = {0u, 0u, 0u, 0u};
  for (int g = 0; g < G; ++g) s = qm31_add(s, qm31_load(partial + 4 * ((long long)c * G + g)));
  qm31_store(out + 4 * (long long)c, s);
}

}  // namespace

// cols (C, 2^log_n); factors (log_n, 4), bit i of a basis index <->
// factor i; the low k <= 11 of them form B_lo; G blocks a row with at
// most 256 high indices each; partial (C, G, 4) scratch; out (C, 4).
extern "C" int nzt_oods_dot(const uint32_t* cols, int C, int log_n, int k,
                            const uint32_t* factors, int G, uint32_t* partial,
                            uint32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k > 11 || k > log_n || C <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const int nhi = 1 << (log_n - k);
  const int per_block = (nhi + G - 1) / G;
  if (per_block > kThreads) return (int)cudaErrorInvalidValue;
  oods_partial<<<dim3((unsigned)G, (unsigned)C), kThreads, 0, st>>>(
      cols, log_n, k, factors, per_block, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  oods_finish<<<(C + 127) / 128, 128, 0, st>>>(partial, C, G, out);
  return (int)cudaGetLastError();
}

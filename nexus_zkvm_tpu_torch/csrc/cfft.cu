// K1: circle FFT / inverse FFT butterfly stages over a batch of rows.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/ops/cfft.py
// `_interpolate` (:73) and `_evaluate` (:137), which the prover runs for
// every trace interpolation, every LDE and the composition basis change.
//
// Layout: (rows, N) uint32, N = 2^log_n.  Stage j views a row as
// (2^(j-1), 2, half) with half = N / 2^j and pairs a = [chunk, 0, k]
// with b = [chunk, 1, k]; twiddle t[k] is shared by every chunk.
//   inverse stage: a <- a + b, b <- (a - b) * t      (t = inverse twiddle)
//   forward stage: a <- f0 + t f1, b <- f0 - t f1
// The inverse's 1/N is folded into its last stage.  One thread per
// butterfly, one launch per stage; a stage may run in place (src == dst)
// because each thread reads and writes only its own pair.
//
// What bounds it on the H100: device memory.  The whole transform needs
// one read and one write of the (rows, N) matrix; this per-stage design
// moves the matrix log_n times over (about 2 * 4 * rows * N * log_n
// bytes), so it sits about log_n times above the bound.  Keeping the
// small-half stages in shared memory (a block owning a whole chunk) is
// the next step; the TPU program's transposed small-half stages were a
// tiling workaround and have no counterpart here.
#include "m31.cuh"

namespace {

__device__ __forceinline__ void pair_index(long long i, int log_n, int log_half,
                                           long long* a, long long* b) {
  long long half = 1LL << log_half;
  long long row = i >> (log_n - 1);
  long long r = i & ((1LL << (log_n - 1)) - 1);
  long long chunk = r >> log_half;
  *a = (row << log_n) + (chunk << (log_half + 1)) + (r & (half - 1));
  *b = *a + half;
}

__global__ void ifft_stage(const uint32_t* src, uint32_t* dst,
                           const uint32_t* __restrict__ tw, long long total,
                           int log_n, int log_half, uint32_t scale) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long a, b;
  pair_index(i, log_n, log_half, &a, &b);
  uint32_t x = src[a], y = src[b];
  uint32_t t = tw[i & ((1LL << log_half) - 1)];
  uint32_t f0 = m31_add(x, y);
  uint32_t f1 = m31_mul(m31_sub(x, y), t);
  if (scale != 1u) {
    f0 = m31_mul(f0, scale);
    f1 = m31_mul(f1, scale);
  }
  dst[a] = f0;
  dst[b] = f1;
}

__global__ void fft_stage(const uint32_t* src, uint32_t* dst,
                          const uint32_t* __restrict__ tw, long long total,
                          int log_n, int log_half) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long a, b;
  pair_index(i, log_n, log_half, &a, &b);
  uint32_t f0 = src[a];
  uint32_t tf1 = m31_mul(tw[i & ((1LL << log_half) - 1)], src[b]);
  dst[a] = m31_add(f0, tf1);
  dst[b] = m31_sub(f0, tf1);
}

constexpr int kThreads = 256;

}  // namespace

// One inverse stage j (1..log_n) over rows x 2^log_n; tw points at the
// stage's 2^(log_n - j) inverse twiddles; scale multiplies the outputs
// (1/N on the last stage, 1 otherwise).
extern "C" int nzt_ifft_stage(const uint32_t* src, uint32_t* dst,
                              const uint32_t* tw, long long rows, int log_n,
                              int j, uint32_t scale, void* stream) {
  long long total = rows << (log_n - 1);
  long long blocks = (total + kThreads - 1) / kThreads;
  ifft_stage<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, tw, total, log_n, log_n - j, scale);
  return (int)cudaGetLastError();
}

// One forward stage j (log_n..1); tw points at the stage's twiddles.
extern "C" int nzt_fft_stage(const uint32_t* src, uint32_t* dst,
                             const uint32_t* tw, long long rows, int log_n,
                             int j, void* stream) {
  long long total = rows << (log_n - 1);
  long long blocks = (total + kThreads - 1) / kThreads;
  fft_stage<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, tw, total, log_n, log_n - j);
  return (int)cudaGetLastError();
}

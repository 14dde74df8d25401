// K1: circle FFT / inverse FFT over a batch of rows, in multi-stage
// passes through shared memory.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/ops/cfft.py
// `_interpolate` (:73) and `_evaluate` (:137), which the prover runs for
// every trace interpolation, every LDE and the composition basis change.
//
// Layout: (rows, N) uint32, N = 2^log_n.  Stage j views a row as
// (2^(j-1), 2, half) with half = N / 2^j and pairs a = [chunk, 0, k]
// with b = [chunk, 1, k]: the stage acts on position bit b = log_n - j,
// and its twiddle is tw[N - 2^(b+1) + (p mod 2^b)] for the pair's a at p.
//   inverse stage: a <- a + b, b <- (a - b) * t      (j = 1..log_n)
//   forward stage: a <- f0 + t f1, b <- f0 - t f1    (j = log_n..1)
// The inverse's 1/N is folded into its last store.
//
// Design.  The stages are grouped into passes (`_pass_plan` in
// ops/cfft.py computes them and passes them here as (lo, hi, wb, s0)
// per pass).  A pass runs the stages of bits [s0, hi) on tiles of
// 2^S words, S = wb + hi - lo: a tile is every position whose bits
// [lo, hi) and [0, wb) vary and whose other bits are fixed.  A pass with
// lo = 0 owns a contiguous run of 2^hi words of one row (the small-half
// stages); a pass with lo > 0 owns 2^(hi-lo) runs of W = 2^wb
// consecutive words, 2^lo words apart (the large-half stages).  A block
// of up to 256 threads copies its tile into shared memory with
// asynchronous copies (every load in flight at once; the slots padded
// one word in 32 against bank conflicts), runs the pass's stages there,
// four at a time in registers between barriers (a thread holds the 16
// words of four stages' butterflies and loads their 15 distinct
// twiddles through the read-only path), and writes the tile back to the
// same positions.  A block reads and writes only its own tile, so a pass
// may run in place (src == dst).  Blocks are ordered row-fastest: the
// rows that share a tile position, and so its slice of the twiddle table
// (up to 64 MB at 2^24, more than the 50 MB L2), run next to each other.
// A 2^14-word tile takes 66 KB, so three blocks share an SM.
//
// The zero-extension of an LDE is fused in: evaluating (rows, 2^log_k)
// coefficients on 2^log_n points, the first log_n - log_k forward stages
// see zero odd halves and only copy, so the first pass reads position p
// from the compact input at p >> (log_n - log_k) and runs stages from
// bit s0 = log_n - log_k.
//
// What bounds it on the H100: the plan takes two passes up to log_n =
// 24, so the matrix crosses device memory twice where the byte floor is
// once; and the butterflies' arithmetic (a canonical M31 product, add
// and subtract each, at the INT32 instruction rate) plus the shared-memory and
// twiddle addressing around it.  On an H100 80GB HBM3 at 700 W the
// forward transform at (244, 2^22) takes 9.9 ms against a 4.0 ms
// operation floor, 2.5x (the old design, one launch a stage, moved the
// matrix log_n times: 63.5 ms).  Offsets into the matrix are 64-bit:
// 438 rows of 2^24 words exceed 2^32 words.
#include <algorithm>

#include <cuda_pipeline.h>

#include "m31.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRadix = 4;  // stages a thread runs in registers per barrier

__device__ __forceinline__ uint32_t min_u32(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

// Canonical M31 arithmetic with one conditional subtract, as a min: for
// x < 2p, min(x, x - p) (unsigned) is x mod p.
__device__ __forceinline__ uint32_t add_p(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return min_u32(s, s - NZT_P);
}

__device__ __forceinline__ uint32_t sub_p(uint32_t a, uint32_t b) {
  uint32_t d = a + NZT_P - b;
  return min_u32(d, d - NZT_P);
}

// a, b < p: the product is at most (p - 1)^2, so its two 31-bit halves
// sum to less than 2p.
__device__ __forceinline__ uint32_t mul_p(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)a * b;
  uint32_t r = ((uint32_t)t & NZT_P) + (uint32_t)(t >> 31);
  return min_u32(r, r - NZT_P);
}

// Shared-memory slot of local word q.  For x, y with disjoint bits,
// pad(x | y) = pad(x) + pad(y): their low five bits add without a carry.
__host__ __device__ __forceinline__ uint32_t pad(uint32_t q) {
  return q + (q >> 5);
}

// R stages on local bits [lb_lo, lb_lo + R) of the tile in shared
// memory: a thread takes a group of 2^R words that differ only in those
// bits and runs the R stages on them in registers.  The word at local
// index q lies at tile-relative position prel(q) = lowbase | (q & (W-1))
// | ((q >> wb) << lo); a stage on global bit b reads its twiddle at
// prel mod 2^b.
template <bool kInv, int R>
__device__ __forceinline__ void radix_step(uint32_t* sh,
                                           const uint32_t* __restrict__ tw,
                                           int log_n, int S, int lb_lo,
                                           int lo, int wb, uint32_t lowbase) {
  constexpr int V = 1 << R;
  const int sh_i = lo + lb_lo - wb;  // global bit of local bit lb_lo
  const uint32_t wmask = (1u << wb) - 1u;
  const uint32_t gmask = (1u << lb_lo) - 1u;
  const int groups = 1 << (S - R);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const uint32_t qb = ((uint32_t)g & gmask) | (((uint32_t)g & ~gmask) << R);
    const uint32_t pq = lowbase | (qb & wmask) | ((qb >> wb) << lo);
    uint32_t* const base = sh + pad(qb);
    uint32_t v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = base[pad((uint32_t)i << lb_lo)];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int st = kInv ? R - 1 - k : k;
      const int b = sh_i + st;
      // pq is zero on the group's bits, so prel mod 2^b of word i is
      // (pq mod 2^b) + (i mod 2^st) << sh_i: 2^st distinct twiddles
      const uint32_t tb = (1u << log_n) - (2u << b) + (pq & ((1u << b) - 1u));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i & (1 << st)) continue;
        const uint32_t t =
            __ldg(tw + (tb + ((uint32_t)(i & ((1 << st) - 1)) << sh_i)));
        uint32_t& x = v[i];
        uint32_t& y = v[i | (1 << st)];
        if (kInv) {
          const uint32_t f0 = add_p(x, y);
          y = mul_p(sub_p(x, y), t);
          x = f0;
        } else {
          const uint32_t ty = mul_p(t, y);
          y = sub_p(x, ty);
          x = add_p(x, ty);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) base[pad((uint32_t)i << lb_lo)] = v[i];
  }
}

template <bool kInv>
__device__ __forceinline__ void radix(int r, uint32_t* sh,
                                      const uint32_t* __restrict__ tw,
                                      int log_n, int S, int lb_lo, int lo,
                                      int wb, uint32_t lowbase) {
  if (r == 4)
    radix_step<kInv, 4>(sh, tw, log_n, S, lb_lo, lo, wb, lowbase);
  else if (r == 3)
    radix_step<kInv, 3>(sh, tw, log_n, S, lb_lo, lo, wb, lowbase);
  else if (r == 2)
    radix_step<kInv, 2>(sh, tw, log_n, S, lb_lo, lo, wb, lowbase);
  else
    radix_step<kInv, 1>(sh, tw, log_n, S, lb_lo, lo, wb, lowbase);
}

// One pass: block = (tile, row), row fastest.  A tile's fixed bits are
// [wb, lo) (its low part, the slower index) and [hi, log_n).  src rows
// hold 2^log_src words (log_src < log_n: the compact LDE input, position
// p read at p >> (log_n - log_src)).  Positions within a row fit in 32
// bits (log_n <= 30); row offsets are 64-bit.
template <bool kInv>
__global__ void __launch_bounds__(kMaxThreads, 3)
cfft_pass(const uint32_t* src, uint32_t* dst, const uint32_t* __restrict__ tw,
          long long rows, int log_n, int log_src, int lo, int hi, int wb,
          int s0, uint32_t scale) {
  extern __shared__ uint32_t sh[];
  const int S = wb + hi - lo;
  const int size = 1 << S;
  const long long row = blockIdx.x % rows;
  const long long tile = blockIdx.x / rows;
  const int nhigh = log_n - hi;
  const uint32_t base = (uint32_t)(((tile & ((1LL << nhigh) - 1)) << hi) |
                                   ((tile >> nhigh) << wb));
  const uint32_t lowbase = base & ((1u << lo) - 1u);
  // a thread's words are q = tid + k * blockDim.x; blockDim.x is a power
  // of two >= 32 >= 2^wb, so q's low wb bits are tid's and its position
  // and slot advance by fixed steps
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint32_t p0 = base | (tid & ((1u << wb) - 1u)) |
                      ((uint32_t)(tid >> wb) << lo);
  const uint32_t pstep = (uint32_t)(nt >> wb) << lo;
  const uint32_t sstep = pad(nt);
  const int e = log_n - log_src;
  const uint32_t* s = src + (row << log_src);
  // asynchronous copies straight into shared memory: every load of the
  // tile in flight at once
  {
    uint32_t p = p0, a = pad(tid);
    for (int q = tid; q < size; q += nt, p += pstep, a += sstep)
      __pipeline_memcpy_async(sh + a, s + (p >> e), sizeof(uint32_t));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int lb_end = wb + (s0 - lo);  // the pass's lowest local stage bit
  if (kInv) {
    for (int top = S; top > lb_end;) {
      const int r = min(kRadix, top - lb_end);
      top -= r;
      radix<kInv>(r, sh, tw, log_n, S, top, lo, wb, lowbase);
      __syncthreads();
    }
  } else {
    for (int bot = lb_end; bot < S;) {
      const int r = min(kRadix, S - bot);
      radix<kInv>(r, sh, tw, log_n, S, bot, lo, wb, lowbase);
      bot += r;
      __syncthreads();
    }
  }
  uint32_t* d = dst + (row << log_n);
  uint32_t p = p0, a = pad(tid);
#pragma unroll 4
  for (int q = tid; q < size; q += nt, p += pstep, a += sstep) {
    uint32_t v = sh[a];
    if (scale != 1u) v = mul_p(v, scale);
    d[p] = v;
  }
}

template <bool kInv>
int run_pass(const uint32_t* src, uint32_t* dst, const uint32_t* tw,
             long long rows, int log_n, int log_src, const int* pass,
             uint32_t scale, cudaStream_t stream) {
  const int lo = pass[0], hi = pass[1], wb = pass[2], s0 = pass[3];
  const int S = wb + hi - lo;
  const long long blocks = rows << (lo - wb + log_n - hi);
  if (wb > 5 || log_n > 30 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = std::min(kMaxThreads, std::max(32, (1 << S) >> 3));
  const size_t smem = (size_t)pad(1u << S) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cfft_pass<kInv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cfft_pass<kInv><<<(unsigned)blocks, threads, smem, stream>>>(
      src, dst, tw, rows, log_n, log_src, lo, hi, wb, s0, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Inverse FFT of rows x 2^log_n: `plan` holds npass passes of four ints
// (lo, hi, wb, s0) in the order they run; the first reads src, every
// later one runs in place in dst; the last multiplies by inv_n.
extern "C" int nzt_circle_ifft(const uint32_t* src, uint32_t* dst,
                               const uint32_t* tw, long long rows, int log_n,
                               uint32_t inv_n, int npass, const int* plan,
                               void* stream) {
  for (int i = 0; i < npass; ++i) {
    int err = run_pass<true>(i == 0 ? src : dst, dst, tw, rows, log_n, log_n,
                             plan + 4 * i, i == npass - 1 ? inv_n : 1u,
                             (cudaStream_t)stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// Forward FFT of rows x 2^log_k coefficients on 2^log_n points
// (log_k <= log_n: zero-extended in the first pass); tw is domain
// log_n's forward table.
extern "C" int nzt_circle_fft(const uint32_t* src, uint32_t* dst,
                              const uint32_t* tw, long long rows, int log_k,
                              int log_n, int npass, const int* plan,
                              void* stream) {
  for (int i = 0; i < npass; ++i) {
    int err = run_pass<false>(i == 0 ? src : dst, dst, tw, rows, log_n,
                              i == 0 ? log_k : log_n, plan + 4 * i, 1u,
                              (cudaStream_t)stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

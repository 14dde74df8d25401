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
//
// The streamed quotients of the large-trace memory mode split K3 in two,
// for size groups whose evaluations are never resident:
//   K11 quotient_colsums replaces `quotients.colsum_fold` (:196), run as
//     `stark.qs_fold` / `stark.qs_fold_lde` (prover/stark.py:1276, :1289):
//     acc[s][p] += sum_k gcs[s][k] * col_k(p) over one (c, M) chunk of
//     columns, the products summed in uint64 (exact mod p) and reduced
//     once a pass of at most 16 columns (the words are canonical, so
//     every chunking gives the same words).  A chunk fresh from K1 is in
//     layout order (brev = 1): point p reads row brev(p).  Read one
//     thread a point, that scattered (a warp's 32 loads of a column
//     2^(log_m - 5) words apart, a 32-byte sector each: 4.69 ms at
//     (2, 16, 2^23) against a 0.32 ms bound).  Now a block copies its 16
//     columns' runs of consecutive rows into a shared-memory tile
//     (brev_tile.cuh); each thread then folds its point from the tile,
//     transposed, and reads and writes acc coalesced in p.  A resident
//     block in committed order (brev = 0) takes the same tiles without
//     the reversals.  Bound: the chunk read once and the (S, M, 4) sums
//     read and written, against the products (close to the bytes at
//     S = 2: each is one multiply-add, the sums folded every 4 columns).
//   K12 quotient_finalize replaces `quotients.colsum_finalize` (:215), run
//     as `stark.qs_final` (prover/stark.py:1297): K3's epilogue over the
//     precomputed sums.  Bound: the per-sample QM31 inverse and products.
// K3 and K12 share the epilogue (`sample_term`).
#include "brev_tile.cuh"
#include "m31.cuh"

#define NZT_MAX_SAMPLES 8

namespace {

// One sample's quotient at point (x, y) from its column sum num:
// (num - A y - B) / V, V = dy (x - z_x) - dx (y - z_y); c holds the
// sample's zx, zy, dx, dy, A, B.
__device__ __forceinline__ qm31 sample_term(qm31 num, uint32_t x, uint32_t y,
                                            const uint32_t* __restrict__ c) {
  qm31 zx = qm31_load(c), zy = qm31_load(c + 4), dx = qm31_load(c + 8);
  qm31 dy = qm31_load(c + 12), A = qm31_load(c + 16), B = qm31_load(c + 20);
  qm31 vx = qm31_sub({x, 0, 0, 0}, zx);
  qm31 vy = qm31_sub({y, 0, 0, 0}, zy);
  qm31 V = qm31_sub(qm31_mul(dy, vx), qm31_mul(dx, vy));
  num = qm31_sub(qm31_sub(num, qm31_mul_m31(A, y)), B);
  return qm31_mul(num, qm31_inv(V));
}

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
    qm31 num = {m31_reduce64(acc[s][0]), m31_reduce64(acc[s][1]),
                m31_reduce64(acc[s][2]), m31_reduce64(acc[s][3])};
    total = qm31_add(total, sample_term(num, x, y, consts + s * 24));
  }
  qm31_store(out + p * 4, total);
}

// x folded once: congruent to x mod p and below 2^33 + 2^31
__device__ __forceinline__ uint64_t m31_fold64(uint64_t x) {
  return (x & NZT_P) + (x >> 31);
}

// K11: columns [0, nk) of `cols`, nk <= 16, in committed order or in
// layout order (brev); block `mid` of the tile plan folds its 2^2t
// points, one a thread.
template <int S>
__global__ void __launch_bounds__(NZT_TILE_THREADS)
    quotient_colsums(uint32_t* __restrict__ acc,
                     const uint32_t* __restrict__ cols,
                     const uint32_t* __restrict__ gcs, int c, int nk,
                     long long M, int log_m, int t, int brev) {
  __shared__ uint32_t tile[NZT_TILE_COLS * NZT_TILE_COL_WORDS];
  __shared__ uint4 g[S][NZT_TILE_COLS];
  const unsigned mid = blockIdx.x;
  for (int i = threadIdx.x; i < S * nk; i += blockDim.x)
    g[i / nk][i % nk] = __ldg(reinterpret_cast<const uint4*>(
        gcs + ((long long)(i / nk) * c + i % nk) * 4));
  brev_tile::load(tile, cols, M, log_m, t, mid, nk, brev);
  if (threadIdx.x >= 1u << (2 * t)) return;
  int word;
  const long long p = brev_tile::point(t, log_m, mid, brev, &word);
  // Products of canonical words (< 2^62 - 2^33 + 4) accumulate with one
  // multiply-add each; a fold after every 4 columns keeps the sums below
  // 2^64, congruent to the exact sums, so the words are those of one
  // reduction of the exact sum.
  uint64_t sum[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
    sum[s][0] = sum[s][1] = sum[s][2] = sum[s][3] = 0;
  for (int k = 0; k < nk; ++k) {
    const uint32_t v = tile[k * NZT_TILE_COL_WORDS + word];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint4 w = g[s][k];
      if ((w.x | w.y | w.z | w.w) == 0u) continue;
      sum[s][0] += (uint64_t)w.x * v;
      sum[s][1] += (uint64_t)w.y * v;
      sum[s][2] += (uint64_t)w.z * v;
      sum[s][3] += (uint64_t)w.w * v;
    }
    if ((k & 3) == 3) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[s][i] = m31_fold64(sum[s][i]);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t* a = acc + ((long long)s * M + p) * 4;
    const qm31 old = qm31_load(a);
    qm31_store(a, {m31_reduce64(sum[s][0] + old.a),
                   m31_reduce64(sum[s][1] + old.b),
                   m31_reduce64(sum[s][2] + old.c),
                   m31_reduce64(sum[s][3] + old.d)});
  }
}

// K11's passes, one a 16 columns
template <int S>
int colsums_passes(uint32_t* acc, const uint32_t* block, const uint32_t* gcs,
                   int c, long long M, int log_m, int brev, int t,
                   long long blocks, cudaStream_t stream) {
  for (int k0 = 0; k0 < c; k0 += NZT_TILE_COLS) {
    quotient_colsums<S><<<(unsigned)blocks, NZT_TILE_THREADS, 0, stream>>>(
        acc, block + (long long)k0 * M, gcs + (long long)k0 * 4, c,
        c - k0 < NZT_TILE_COLS ? c - k0 : NZT_TILE_COLS, M, log_m, t, brev);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

__global__ void quotient_finalize(const uint32_t* __restrict__ acc,
                                  const uint32_t* __restrict__ xs,
                                  const uint32_t* __restrict__ ys,
                                  const uint32_t* __restrict__ consts, int S,
                                  long long M, uint32_t* __restrict__ out) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  uint32_t x = __ldg(xs + p), y = __ldg(ys + p);
  qm31 total = {0, 0, 0, 0};
  for (int s = 0; s < S; ++s)
    total = qm31_add(total, sample_term(
        qm31_load(acc + ((long long)s * M + p) * 4), x, y, consts + s * 24));
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

// acc (S, M, 4) canonical sums, added to in place; block (c, M) columns
// in committed order, or in layout order (brev = 1); gcs (S, c, 4);
// (t, blocks) the tile plan of brev_tile.cuh.  One launch a 16 columns.
extern "C" int nzt_quotient_colsums(uint32_t* acc, const uint32_t* block,
                                    const uint32_t* gcs, int S, int c,
                                    long long M, int log_m, int brev, int t,
                                    long long blocks, void* stream) {
  if (S < 1 || S > NZT_MAX_SAMPLES || c < 1 ||
      !brev_tile::plan_ok(log_m, t, blocks) || M != (1LL << log_m))
    return (int)cudaErrorInvalidValue;
  using Passes = int (*)(uint32_t*, const uint32_t*, const uint32_t*, int,
                         long long, int, int, int, long long, cudaStream_t);
  static const Passes passes[NZT_MAX_SAMPLES] = {
      colsums_passes<1>, colsums_passes<2>, colsums_passes<3>,
      colsums_passes<4>, colsums_passes<5>, colsums_passes<6>,
      colsums_passes<7>, colsums_passes<8>};
  return passes[S - 1](acc, block, gcs, c, M, log_m, brev, t, blocks,
                        (cudaStream_t)stream);
}

// acc (S, M, 4) column sums of K11; consts (S, 6, 4); out (M, 4).
extern "C" int nzt_quotient_finalize(const uint32_t* acc, const uint32_t* xs,
                                     const uint32_t* ys, const uint32_t* consts,
                                     int S, long long M, uint32_t* out,
                                     void* stream) {
  if (S < 1 || S > NZT_MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  long long blocks = (M + kThreads - 1) / kThreads;
  quotient_finalize<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      acc, xs, ys, consts, S, M, out);
  return (int)cudaGetLastError();
}

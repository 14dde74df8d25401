// K3: DEEP quotient accumulation over one committed size group.
//
// Replaces the JAX package's device program nexus_zkvm_tpu/ops/quotients.py
// `_accumulate_blocks` (:157), run as `stark.quotients2`
// (nexus_zkvm_tpu/prover/stark.py:1013), and covers its gather variant
// `_accumulate_raw` (:125).  Per domain point p (committed order):
//   num_s(p) = sum_k gcs[s][k] col_k(p) - A_s y_p - B_s,
//   V_s(p)   = dy_s (x_p - zx_s) - dx_s (y_p - zy_s),
//   out(p)   = sum_s num_s(p) / V_s(p)                  (QM31)
// over the group's columns, which arrive as up to four role blocks (pre,
// main, inter, comp) of M words a row: no (K, M) gather is ever built.
//
// What bounds it on the H100: the bytes, one read of the (K, M)
// evaluations (4 K M bytes; 1.11 ms at (438, 2^21)).  The products are
// one widening multiply-add each (a few tenths of a ms there), and the
// epilogue a few hundred operations a point.  So the design is about
// keeping enough bytes in flight.
//
// Columns through a shared-memory ring.  A block owns a run of
// consecutive points (kQThreads x `points` of them, M when M is smaller)
// and streams the group's columns through a ring of `stages` stages of
// `cols` columns x the run (`k3_shape`).  A column's run is contiguous,
// so a stage is `cols` Hopper bulk asynchronous copies (cp.async.bulk
// into shared memory, completing on the stage's mbarrier), plus one of
// the stage's coefficients gcs[s][k0 .. k0 + cols) per sample.  Warp 0
// issues them (lane i one copy), stages - 1 stages ahead of the fold:
// 64 KB in flight a block at two samples, with no registers spent on
// it.  A stage may straddle two role blocks: the producer maps the
// group's column k to its (block, row).  Thread t folds points t +
// kQThreads q of the run from the stage, conflict-free; the coefficients
// are broadcast reads, a zero one (a column absent from a sample) a
// uniform skip.  The shapes come from probes on the H100 at the fib 2^20
// proof's groups (PERF.md): at S <= 2, 4 points a thread and
// stages of 8 columns (32 KB) beat 1 or 2 points and stages of 16 or 32;
// from S = 3 the sums of 4 points spill, and one point a thread with
// stages of 32 columns was fastest.  A group of few points and many
// columns (64 x 4470 in that proof) is one block walking its stages, so
// it waits on each copy in turn.
//
// Lazy sums.  Each thread keeps per point and sample four uint64 sums of
// raw products (uint64) g * v, folded (`m31_fold64`) after every 4
// columns: a word is at most p and a coefficient at most p - 1, so the
// sums never wrap, and they stay congruent to the exact sums, so the
// words are those of one reduction of the exact sum.
//
// The epilogue (`quotient_sum`, shared with K12).  Per sample,
//   V_s(p) = x_p dy_s - y_p dx_s + c0_s,  c0_s = dx_s zy_s - dy_s zx_s,
// a field identity (the words do not change): 8 M31 x M31 products a
// sample and point instead of two QM31 products, c0_s formed once a
// block from `consts`, whatever its values.  Each V_s becomes its M31
// norm and the adjugate (qm31_lazy.cuh `norm_adj`), num_s times the
// adjugate is a lazily reduced QM31 product, and all of a thread's norms
// (samples x points) share one M31 inverse by Montgomery's trick
// (`invert_batch`), a zero norm (V = 0) giving a zero term, as the plain
// qm31_inv(0) = 0 does.  That is about a third of the operations of two
// full QM31 products and a QM31 inverse (402) a sample and point.
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
//     (S, M, 4) sums, kFPoints points a thread so that each M31 inverse
//     serves S x kFPoints norms.  Bound: the epilogue's operations, above
//     the bytes of the sums, the points and the output.
#include "brev_tile.cuh"
#include "qm31_lazy.cuh"

#define NZT_MAX_SAMPLES 8

namespace {

// K3's shape for S samples (ops/quotients.py QUOTIENT_PLAN mirrors it):
// kQThreads threads a block, `points` points a thread, `cols` columns a
// stage (a multiple of 4), `stages` stages in the ring.  Few samples
// take long runs (more bytes a copy, one inverse for 4 S norms); more
// samples, whose sums fill the registers, one point a thread and wider
// stages.
constexpr int kQThreads = 256;
constexpr int kQFewSamples = 2;
template <int S>
struct k3_shape {
  static constexpr int points = S <= kQFewSamples ? 4 : 1;
  static constexpr int cols = S <= kQFewSamples ? 8 : 32;
  static constexpr int stages = S <= kQFewSamples ? 3 : 2;
  static constexpr int run = kQThreads * points;
};
// K12's: threads a block, points a thread
constexpr int kFThreads = 128;
constexpr int kFPoints = 2;
// a sample's constants as the epilogue reads them: dx, dy, A, B, c0
constexpr int kConsts = 5;

// -- Hopper bulk copies and mbarriers ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive once, the stage's copies to bring `bytes`
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- The epilogue, shared by K3 and K12 -------------------------------------

// sample s's constants from consts (zx, zy, dx, dy, A, B): dx, dy, A, B
// and c0 = dx zy - dy zx
__device__ __forceinline__ void sample_consts(qm31* __restrict__ dst,
                                              const uint32_t* __restrict__ c) {
  const qm31 zx = qm31_load(c), zy = qm31_load(c + 4);
  const qm31 dx = qm31_load(c + 8), dy = qm31_load(c + 12);
  dst[0] = dx;
  dst[1] = dy;
  dst[2] = qm31_load(c + 16);
  dst[3] = qm31_load(c + 20);
  dst[4] = qm31_sub(qmul(dx, zy), qmul(dy, zx));
}

// sum over samples of (sum_s - A_s y - B_s) / V_s at NP points (x, y),
// sum[q][s] the column sums of point q (each below 2^33 + 2^31 and
// congruent to the sum mod p), cst the samples' constants
template <int S, int NP>
__device__ __forceinline__ void quotient_sum(const uint64_t (&sum)[NP][S][4],
                                             const uint32_t (&x)[NP],
                                             const uint32_t (&y)[NP],
                                             const qm31* __restrict__ cst,
                                             qm31 (&total)[NP]) {
  qm31 t[NP * S];
  uint32_t m[NP * S];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const uint32_t ny = NZT_P - y[q];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const qm31* c = cst + s * kConsts;
      const qm31 dx = c[0], dy = c[1], A = c[2], B = c[3], c0 = c[4];
      // V = x dy - y dx + c0, num = sum - A y - B: one reduction a word
      const qm31 V = {m31_reduce64(prod(x[q], dy.a) + prod(ny, dx.a) + c0.a),
                      m31_reduce64(prod(x[q], dy.b) + prod(ny, dx.b) + c0.b),
                      m31_reduce64(prod(x[q], dy.c) + prod(ny, dx.c) + c0.c),
                      m31_reduce64(prod(x[q], dy.d) + prod(ny, dx.d) + c0.d)};
      const qm31 num = {
          m31_reduce64(sum[q][s][0] + prod(ny, A.a) + (NZT_P - B.a)),
          m31_reduce64(sum[q][s][1] + prod(ny, A.b) + (NZT_P - B.b)),
          m31_reduce64(sum[q][s][2] + prod(ny, A.c) + (NZT_P - B.c)),
          m31_reduce64(sum[q][s][3] + prod(ny, A.d) + (NZT_P - B.d))};
      const norm_adj_t na = norm_adj(V);
      t[q * S + s] = qmul(num, na.adj);
      m[q * S + s] = na.m;
    }
  }
  invert_batch(m);                         // one M31 inverse for all
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    total[q] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < S; ++s)
      total[q] = qm31_add(total[q], qmul31(t[q * S + s], m[q * S + s]));
  }
}

// x folded once: congruent to x mod p and below 2^33 + 2^31, so four
// more products of a word up to p and a coefficient up to p - 1 keep a
// uint64 sum below 2^64.  A mask, a shift and an add, off the multiply
// pipe that the products fill: on an H100 a fold by one multiply-add
// (s mod 2^32 + 2 (s >> 32), K8's) made K3 6 % and K11 3-12 % slower.
__device__ __forceinline__ uint64_t m31_fold64(uint64_t x) {
  return (x & NZT_P) + (x >> 31);
}

// -- K3 -----------------------------------------------------------------------

struct role_blocks {
  const uint32_t* ptr[4];
  int rows[4];
};

// bytes of K3's dynamic shared memory for S samples: the ring, the
// stages' coefficients, the samples' constants, the barriers
template <int S>
constexpr size_t k3_smem() {
  using K3 = k3_shape<S>;
  return sizeof(uint32_t) * K3::stages * K3::cols * K3::run +
         sizeof(uint4) * K3::stages * S * K3::cols +
         sizeof(qm31) * S * kConsts + sizeof(uint64_t) * K3::stages;
}

// warp 0: stage st of the group's columns into ring slot st % stages
// (its n-word runs at point p0) and its coefficients, on that slot's
// barrier
template <int S>
__device__ __forceinline__ void issue_stage(const role_blocks& rb,
                                            const uint32_t* __restrict__ gcs,
                                            int K, long long M, long long p0,
                                            int n, int st, uint32_t* ring,
                                            uint4* gs, uint64_t* bar) {
  using K3 = k3_shape<S>;
  const int lane = threadIdx.x & 31, slot = st % K3::stages;
  const int k0 = st * K3::cols, nk = min(K3::cols, K - k0);
  if (lane == 0) {
    // the proxies: earlier generic reads of the slot before its refill
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_expect(bar + slot, (uint32_t)nk * (4u * n + 16u * S));
  }
  __syncwarp();
  for (int i = lane; i < nk + S; i += 32) {
    if (i < nk) {
      int k = k0 + i, r = 0;
      while (k >= rb.rows[r]) k -= rb.rows[r++];
      bulk_load(ring + ((long long)slot * K3::cols + i) * K3::run,
                rb.ptr[r] + (long long)k * M + p0, 4u * n, bar + slot);
    } else {
      const int s = i - nk;
      bulk_load(gs + (slot * S + s) * K3::cols,
                gcs + ((long long)s * K + k0) * 4, 16u * nk, bar + slot);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kQThreads, 2)
    deep_quotients(const role_blocks rb, const uint32_t* __restrict__ xs,
                   const uint32_t* __restrict__ ys,
                   const uint32_t* __restrict__ consts,
                   const uint32_t* __restrict__ gcs, int K, long long M,
                   uint32_t* __restrict__ out) {
  using K3 = k3_shape<S>;
  constexpr int NP = K3::points, C = K3::cols, D = K3::stages, R = K3::run;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint4* gs = reinterpret_cast<uint4*>(ring + D * C * R);
  qm31* cst = reinterpret_cast<qm31*>(gs + D * S * C);
  uint64_t* bar = reinterpret_cast<uint64_t*>(cst + S * kConsts);
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * R;
  const int n = (int)min((long long)R, M - p0);
  const int stages = (K + C - 1) / C;
  if (tid == 0) {
    for (int i = 0; i < D; ++i) bar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < S) sample_consts(cst + tid * kConsts, consts + tid * 24);
  __syncthreads();
  if (tid < 32)
    for (int st = 0; st < D - 1 && st < stages; ++st)
      issue_stage<S>(rb, gcs, K, M, p0, n, st, ring, gs, bar);

  uint64_t sum[NP][S][4];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int s = 0; s < S; ++s)
      sum[q][s][0] = sum[q][s][1] = sum[q][s][2] = sum[q][s][3] = 0;
  for (int st = 0; st < stages; ++st) {
    // refill the slot the last stage freed, then fold this one
    if (tid < 32 && st + D - 1 < stages)
      issue_stage<S>(rb, gcs, K, M, p0, n, st + D - 1, ring, gs, bar);
    const int slot = st % D;
    bar_wait(bar + slot, (st / D) & 1);
    const uint32_t* col = ring + slot * C * R + tid;
    const uint4* g = gs + slot * S * C;
    const int nk = min(C, K - st * C);
    for (int k4 = 0; k4 < nk; k4 += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k4 + j;
        if (k < nk) {
          uint32_t v[NP];
#pragma unroll
          for (int q = 0; q < NP; ++q)
            v[q] = col[k * R + q * kQThreads];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const uint4 w = g[s * C + k];
            if ((w.x | w.y | w.z | w.w) == 0u) continue;
#pragma unroll
            for (int q = 0; q < NP; ++q) {
              sum[q][s][0] += prod(w.x, v[q]);
              sum[q][s][1] += prod(w.y, v[q]);
              sum[q][s][2] += prod(w.z, v[q]);
              sum[q][s][3] += prod(w.w, v[q]);
            }
          }
        }
      }
      // at most 4 products since the last fold (C is a multiple of 4)
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum[q][s][i] = m31_fold64(sum[q][s][i]);
    }
    __syncthreads();                       // the slot is free again
  }

  uint32_t x[NP], y[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int i = q * kQThreads + tid;
    x[q] = i < n ? __ldg(xs + p0 + i) : 0u;
    y[q] = i < n ? __ldg(ys + p0 + i) : 0u;
  }
  qm31 total[NP];
  quotient_sum<S, NP>(sum, x, y, cst, total);
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int i = q * kQThreads + tid;
    if (i < n) qm31_store(out + (p0 + i) * 4, total[q]);
  }
}

template <int S>
int deep_quotients_launch(const role_blocks& rb, const uint32_t* xs,
                          const uint32_t* ys, const uint32_t* consts,
                          const uint32_t* gcs, int K, long long M,
                          uint32_t* out, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      deep_quotients<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)k3_smem<S>());
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (M + k3_shape<S>::run - 1) / k3_shape<S>::run;
  deep_quotients<S><<<(unsigned)blocks, kQThreads, k3_smem<S>(), stream>>>(
      rb, xs, ys, consts, gcs, K, M, out);
  return (int)cudaGetLastError();
}

// -- K11 ----------------------------------------------------------------------

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
  // multiply-add each; a fold (`m31_fold64`) after every 4 columns keeps
  // the sums below 2^64, congruent to the exact sums, so the words are
  // those of one reduction of the exact sum.
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

// -- K12 ----------------------------------------------------------------------

template <int S>
__global__ void __launch_bounds__(kFThreads)
    quotient_finalize(const uint32_t* __restrict__ acc,
                      const uint32_t* __restrict__ xs,
                      const uint32_t* __restrict__ ys,
                      const uint32_t* __restrict__ consts, long long M,
                      uint32_t* __restrict__ out) {
  __shared__ qm31 cst[S * kConsts];
  if (threadIdx.x < S)
    sample_consts(cst + threadIdx.x * kConsts, consts + threadIdx.x * 24);
  __syncthreads();
  const long long p0 =
      (long long)blockIdx.x * kFThreads * kFPoints + threadIdx.x;
  uint64_t sum[kFPoints][S][4];
  uint32_t x[kFPoints], y[kFPoints];
#pragma unroll
  for (int q = 0; q < kFPoints; ++q) {
    const long long p = min(p0 + q * kFThreads, M - 1);
    x[q] = __ldg(xs + p);
    y[q] = __ldg(ys + p);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint4 a =
          __ldg(reinterpret_cast<const uint4*>(acc + (s * M + p) * 4));
      sum[q][s][0] = a.x;
      sum[q][s][1] = a.y;
      sum[q][s][2] = a.z;
      sum[q][s][3] = a.w;
    }
  }
  qm31 total[kFPoints];
  quotient_sum<S, kFPoints>(sum, x, y, cst, total);
#pragma unroll
  for (int q = 0; q < kFPoints; ++q)
    if (p0 + q * kFThreads < M)
      qm31_store(out + (p0 + q * kFThreads) * 4, total[q]);
}

template <int S>
int quotient_finalize_launch(const uint32_t* acc, const uint32_t* xs,
                             const uint32_t* ys, const uint32_t* consts,
                             long long M, uint32_t* out, cudaStream_t stream) {
  const long long per = (long long)kFThreads * kFPoints;
  quotient_finalize<S><<<(unsigned)((M + per - 1) / per), kFThreads, 0,
                          stream>>>(acc, xs, ys, consts, M, out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// blocks b0..b3 with n0..n3 rows of M committed-order evaluations
// (unused blocks have 0 rows); consts (S, 6, 4); gcs (S, K, 4) with
// K = n0 + n1 + n2 + n3; out (M, 4).  The bulk copies need M a multiple
// of 4 and the blocks and gcs 16-byte aligned.
extern "C" int nzt_deep_quotients(const uint32_t* b0, const uint32_t* b1,
                                  const uint32_t* b2, const uint32_t* b3,
                                  int n0, int n1, int n2, int n3,
                                  const uint32_t* xs, const uint32_t* ys,
                                  const uint32_t* consts, const uint32_t* gcs,
                                  int S, int K, long long M, uint32_t* out,
                                  void* stream) {
  const role_blocks rb = {{b0, b1, b2, b3}, {n0, n1, n2, n3}};
  if (S < 1 || S > NZT_MAX_SAMPLES || n0 + n1 + n2 + n3 != K || M < 4 ||
      M % 4 || !aligned16(gcs))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < 4; ++r)
    if (rb.rows[r] < 0 || (rb.rows[r] && !aligned16(rb.ptr[r])))
      return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const role_blocks&, const uint32_t*, const uint32_t*,
                         const uint32_t*, const uint32_t*, int, long long,
                         uint32_t*, cudaStream_t);
  static const Launch launch[NZT_MAX_SAMPLES] = {
      deep_quotients_launch<1>, deep_quotients_launch<2>,
      deep_quotients_launch<3>, deep_quotients_launch<4>,
      deep_quotients_launch<5>, deep_quotients_launch<6>,
      deep_quotients_launch<7>, deep_quotients_launch<8>};
  return launch[S - 1](rb, xs, ys, consts, gcs, K, M, out,
                       (cudaStream_t)stream);
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
  if (S < 1 || S > NZT_MAX_SAMPLES || M < 1)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                         const uint32_t*, long long, uint32_t*, cudaStream_t);
  static const Launch launch[NZT_MAX_SAMPLES] = {
      quotient_finalize_launch<1>, quotient_finalize_launch<2>,
      quotient_finalize_launch<3>, quotient_finalize_launch<4>,
      quotient_finalize_launch<5>, quotient_finalize_launch<6>,
      quotient_finalize_launch<7>, quotient_finalize_launch<8>};
  return launch[S - 1](acc, xs, ys, consts, M, out, (cudaStream_t)stream);
}

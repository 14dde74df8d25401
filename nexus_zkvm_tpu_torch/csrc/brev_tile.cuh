// Rows read through shared-memory tiles (kernels K10, K11).
//
// A chunk fresh from K1 is a (c, M) column matrix in layout order, M =
// 2^log_m: point m (committed order) reads row brev(m).  One thread a
// point reading chunk[k M + brev(m)] scatters: neighbouring points differ
// in their lowest bits, so their rows differ in the highest, and each
// 4-byte load fetches a 32-byte sector of its own.
//
// Write m = (hi | mid | lo), hi and lo t bits each, mid the log_m - 2t
// bits between.  Then
//
//   brev(m) = (brev_t(lo) | brev(mid) | brev_t(hi)),
//
// so with mid and lo fixed, the 2^t points of every hi read 2^t
// consecutive rows.  A block owns one mid and its 2^2t points, one a
// thread.  `load` copies each column's 2^t runs of 2^t rows (one run a
// lo) into the tile with cp.async, neighbouring threads on neighbouring
// words.  `point` gives each thread its point, neighbouring lo in
// neighbouring lanes (so the caller's own per-point reads and writes are
// coalesced), and the tile word it reads, transposed: run a =
// brev_t(lo), word j = brev_t(hi).  A chunk in committed order (brev = 0)
// takes the same tiles with every bit reversal left out: run a = hi,
// word j = lo.  A warp's 32 points span 16 values of one of a, j and two
// of the other (bit 3 apart when reversed); `slot` stores word j of run a
// at a 2^t + (j ^ (a >> 1)), so their reads, and the copy's writes, fall
// in 32 banks (a row padded by one word would leave 2-way conflicts at
// t = 4).
//
// t = min(NZT_TILE_LOG, floor(log_m / 2)): small chunks take a smaller
// tile in the same kernel, down to t = 0 (one point a block), the
// threads past the tile's points only loading.  ops/circle.py
// `brev_tile_plan` computes t and the block count 2^(log_m - 2t) that
// the wrappers pass; tests/test_torch_brev_tile.py emulates this index
// math.
#pragma once

#include <cstdint>

#define NZT_TILE_LOG 4                          // runs of at most 16 words
#define NZT_TILE_THREADS (1 << 2 * NZT_TILE_LOG)  // a thread a point
#define NZT_TILE_COLS 16                        // columns a tile holds
#define NZT_TILE_COL_WORDS NZT_TILE_THREADS     // words of a column's tile

namespace brev_tile {

// the low `bits` bits of x, reversed (0 for no bits)
__device__ __forceinline__ unsigned rev(unsigned x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// offset of word j of run a in a column's tile of 2^t runs
__device__ __forceinline__ int slot(int a, int j, int t) {
  return (a << t) | (j ^ ((a >> 1) & ((1 << t) - 1)));
}

// true where the plan (t, blocks) fits a chunk of 2^log_m rows
__host__ __forceinline__ bool plan_ok(int log_m, int t, long long blocks) {
  return t >= 0 && t <= NZT_TILE_LOG && 2 * t <= log_m && log_m <= 31 &&
         blocks == (1LL << (log_m - 2 * t));
}

// Copy columns [0, nk) of `cols` (rows of M words) for block `mid` into
// `tile` (NZT_TILE_COL_WORDS a column): word j of run a of column k is
// row (a << (log_m - t)) | (brev(mid) << t) | j (mid itself for brev =
// 0).  Ends with the block synchronized.
__device__ __forceinline__ void load(uint32_t* tile,
                                     const uint32_t* __restrict__ cols,
                                     long long M, int log_m, int t,
                                     unsigned mid, int nk, bool brev) {
  const int T = 1 << t;
  const long long mid_row =
      (long long)(brev ? rev(mid, log_m - 2 * t) : mid) << t;
  for (int w = threadIdx.x; w < nk << (2 * t); w += blockDim.x) {
    const int k = w >> (2 * t), a = (w >> t) & (T - 1), j = w & (T - 1);
    const uint32_t* src =
        cols + k * M + ((long long)a << (log_m - t)) + mid_row + j;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(
        tile + k * NZT_TILE_COL_WORDS + slot(a, j, t));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Point q = threadIdx.x (q < 2^2t, lo = its low t bits) of block `mid`:
// its committed index m = (hi << (log_m - t)) | (mid << t) | lo, and in
// `word` its offset in a column's tile.
__device__ __forceinline__ long long point(int t, int log_m, unsigned mid,
                                           bool brev, int* word) {
  const unsigned q = threadIdx.x, lo = q & ((1 << t) - 1), hi = q >> t;
  *word = brev ? slot(rev(lo, t), rev(hi, t), t) : slot(hi, lo, t);
  return ((long long)hi << (log_m - t)) | ((long long)mid << t) | lo;
}

}  // namespace brev_tile

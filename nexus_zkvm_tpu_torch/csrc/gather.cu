// K9: the opening gather of a proof.
//
// Replaces the JAX package's device program nexus_zkvm_tpu/ops/merkle.py
// `decommit_many_fused` (:440, aot_call :482): the column values at the
// queried positions and the sibling-hash rows of every Merkle opening of
// a proof, gathered into one buffer that reaches the host in one copy;
// and the gather of each recomputed column chunk of a streamed tree
// (nexus_zkvm_tpu/prover/pcs.py:350 `stream_open`).
//
// A piece (a descriptor, fields D_* below, int64 each) gathers
//   out[off + (r * n + i) * W + t] = src[r * rs + idx[i] * is + t * ts]
// for r < rows, i < n, t < W = 2^wlog (W <= 8): the (C, Q) values of a
// uniform tree's column matrix (W 1), a mixed tree's column (rows 1, W
// 1), a layer's sibling digests (rows 1, W 8).  Strides in words let a
// transposed view (FRI's layer matrices) be read in place.
//
// What bounds it on the H100.  The bytes, counted once: every output
// word written, every source word read, 2.85 MB for the fib 2^20 proof's
// 355,906 words, 0.00088 ms at 3.35 TB/s.  But a value is one scattered
// 4-byte read and the card moves 32-byte sectors (about 11.4 MB, 3.4 us),
// and one launch costs a few us: latency sets the floor, not bandwidth.
// So the design spreads the reads over every SM and keeps many of them
// in flight:
//   - `ops/merkle.py` `gather_plan` cuts every piece into units of at
//     most kUnit output words, one block each (a unit table entry:
//     piece << 32 | first word).  A wide piece at a small tree, such as
//     a (3781, 64) matrix opened at 50 positions, then spreads over the
//     card instead of one SM walking it.
//   - A block stages its unit's indices in shared memory: its words
//     belong to consecutive pairs p = r * n + i from p0, so s_idx[j] =
//     idx[(p0 + j) mod n], read coalesced.
//   - No 64-bit divide: r = p / n is a 32-bit quotient by the piece's
//     magic multiplier, r = (p * magic) >> shift, exact for p < 2^31
//     (the host computes magic = ceil(2^shift / n), shift = 31 +
//     ceil(log2 n); the wrappers raise on a gather of 2^31 words).  The
//     source offset r * rs + idx * is + t * ts stays 64-bit: a resident
//     (244, 2^23) tree spans 2^31 words.
//   - Each thread issues all of its kPer loads before it stores any.  A
//     digest piece whose rows are 16-byte aligned (the host's vec flag)
//     reads each half-row as one 16-byte load; one that is not takes the
//     word path.
// On the H100, 4 words a thread (units of 1024 words) ran the fib 2^20
// proof's gather faster than 8 or 16; its 244 pieces make a few hundred
// units, one wave of blocks.
// Two entries share the body: the table entry for a proof's openings
// (one host-to-device copy of the packed descriptors, units and
// indices), and a single-piece entry for a column chunk, its descriptor
// passed by value and its indices already on the card.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                      // output words a thread
constexpr int kUnit = kThreads * kPer;       // `ops/merkle.py` GATHER_UNIT
// descriptor fields, int64 each (`ops/merkle.py` GATHER_FIELDS)
enum { D_SRC, D_OUT, D_IDX, D_N, D_WLOG, D_ROWS, D_RS, D_IS, D_TS, D_MAGIC,
       D_SHIFT, D_VEC, D_FIELDS };

struct Piece {
  const uint32_t* src;
  const long long* idx;      // the piece's n indices
  long long out, rs, is, ts;
  unsigned n, wlog, magic, shift, vec, words;
};

__device__ __forceinline__ unsigned quot(unsigned p, const Piece& d) {
  return (unsigned)(((unsigned long long)p * d.magic) >> d.shift);
}

__device__ __forceinline__ void gather_unit(const Piece& d, unsigned start,
                                            uint32_t* __restrict__ out) {
  __shared__ unsigned s_idx[kUnit + 1];
  const unsigned end = min(start + (unsigned)kUnit, d.words);
  const unsigned p0 = start >> d.wlog;
  const unsigned np = ((end - 1) >> d.wlog) - p0 + 1;
  for (unsigned j = threadIdx.x; j < np; j += kThreads) {
    const unsigned p = p0 + j;
    s_idx[j] = (unsigned)__ldg(d.idx + (p - quot(p, d) * d.n));
  }
  __syncthreads();
  uint32_t* dst = out + d.out;
  if (d.vec) {
    // W 8, ts 1: a digest row as two 16-byte halves, kPer / 4 a thread
    uint4 v[kPer / 4];
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const unsigned e = start + 4 * (threadIdx.x + k * kThreads);
      if (e < end) {
        const unsigned p = e >> 3;
        v[k] = __ldg(reinterpret_cast<const uint4*>(
            d.src + (long long)quot(p, d) * d.rs +
            (long long)s_idx[p - p0] * d.is + (e & 7)));
      }
    }
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const unsigned e = start + 4 * (threadIdx.x + k * kThreads);
      if (e < end) {
        uint32_t* o = dst + e;
        if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
          *reinterpret_cast<uint4*>(o) = v[k];
        } else {
          o[0] = v[k].x; o[1] = v[k].y; o[2] = v[k].z; o[3] = v[k].w;
        }
      }
    }
    return;
  }
  const unsigned tmask = (1u << d.wlog) - 1;
  uint32_t v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned e = start + threadIdx.x + k * kThreads;
    if (e < end) {
      const unsigned p = e >> d.wlog;
      v[k] = __ldg(d.src + (long long)quot(p, d) * d.rs +
                   (long long)s_idx[p - p0] * d.is + (long long)(e & tmask) * d.ts);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned e = start + threadIdx.x + k * kThreads;
    if (e < end) dst[e] = v[k];
  }
}

// one block a unit of the table; desc (G, D_FIELDS), units, idx: the
// packed device copy of `gather_plan`'s tables
__global__ void __launch_bounds__(kThreads)
gather_openings(const long long* __restrict__ desc,
                const long long* __restrict__ units,
                const long long* __restrict__ idx, uint32_t* __restrict__ out) {
  const long long u = __ldg(units + blockIdx.x);
  const long long* f = desc + D_FIELDS * (u >> 32);
  Piece d;
  d.src = reinterpret_cast<const uint32_t*>(__ldg(f + D_SRC));
  d.idx = idx + __ldg(f + D_IDX);
  d.out = __ldg(f + D_OUT);
  d.rs = __ldg(f + D_RS);
  d.is = __ldg(f + D_IS);
  d.ts = __ldg(f + D_TS);
  d.n = (unsigned)__ldg(f + D_N);
  d.wlog = (unsigned)__ldg(f + D_WLOG);
  d.magic = (unsigned)__ldg(f + D_MAGIC);
  d.shift = (unsigned)__ldg(f + D_SHIFT);
  d.vec = (unsigned)__ldg(f + D_VEC);
  d.words = (unsigned)((__ldg(f + D_ROWS) * __ldg(f + D_N)) << d.wlog);
  gather_unit(d, (unsigned)(u & 0xffffffffll), out);
}

// one block a unit of a single piece passed by value
__global__ void __launch_bounds__(kThreads)
gather_piece(const Piece d, uint32_t* __restrict__ out) {
  gather_unit(d, blockIdx.x * (unsigned)kUnit, out);
}

}  // namespace

// buf: the packed int64 tables of `gather_plan` on the card (n_desc
// descriptors, n_units unit entries, then the indices); out int32 words.
extern "C" int nzt_gather_openings(const long long* buf, int n_desc,
                                   int n_units, uint32_t* out, void* stream) {
  if (n_desc <= 0 || n_units <= 0) return (int)cudaErrorInvalidValue;
  const long long* units = buf + (long long)D_FIELDS * n_desc;
  gather_openings<<<(unsigned)n_units, kThreads, 0, (cudaStream_t)stream>>>(
      buf, units, units + n_units, out);
  return (int)cudaGetLastError();
}

// out (rows, n) = src[r * rs + idx[i] * is]: a column chunk at n
// positions (idx int64 on the card, each below the source's width).
extern "C" int nzt_gather_columns(const uint32_t* src, long long rows,
                                  long long rs, long long is,
                                  const long long* idx, long long n,
                                  uint32_t* out, void* stream) {
  if (rows <= 0 || n <= 0 || rows * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  unsigned l = 0;
  while ((1ll << l) < n) ++l;
  Piece d;
  d.src = src;
  d.idx = idx;
  d.out = 0;
  d.rs = rs;
  d.is = is;
  d.ts = 0;
  d.n = (unsigned)n;
  d.wlog = 0;
  d.shift = 31 + l;
  d.magic = (unsigned)(((1ull << d.shift) + n - 1) / n);
  d.vec = 0;
  d.words = (unsigned)(rows * n);
  gather_piece<<<(d.words + kUnit - 1) / kUnit, kThreads, 0,
                 (cudaStream_t)stream>>>(d, out);
  return (int)cudaGetLastError();
}

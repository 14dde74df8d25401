// K6: the LogUp interaction columns of one component.
//
// Replaces the JAX package's device program nexus_zkvm_tpu/air/
// component.py `_gen_interaction_body` (:346, launched through
// `generate_interaction` :407 from prover/stark.py :314): after the
// component's evaluate() has produced its fractions, pair b combines
//   f_b = (n1 d2 + n2 d1) / (d1 d2)                    (QM31)
// and the output (B, M, 4) holds S_b = f_0 + .. + f_b for b < B - 1 and,
// as its last column, the prefix sum over rows of the row totals S_{B-1}.
//
// Operands: the four operands of every pair live in one uint32 buffer
// `src`; meta[(k * B + b) * 2 + {0, 1}] gives operand k (n1, d1, n2, d2)
// of pair b as (word offset, mode): mode 0 an M31 constant, 1 an M31
// column (one word a row), 2 a QM31 constant, 3 a QM31 column (four words
// a row).  Constant numerators (the usual multiplicity 1) and M31 columns
// are read as they are: nothing is widened to (M, 4) first.  Each block
// copies the table into shared memory once; the wrapper keeps its device
// copy per tape.
//
// Batched inversion.  1/den of a QM31 den = A + B u is
//   (A - B u) conj(c) / |c|^2,  c = A^2 - R B^2 (CM31), |c|^2 in M31,
// so every pair needs one M31 inverse (of |c|^2, or of den itself when
// den is M31).  A thread takes its row's pairs kChunk at a time: for
// each it keeps t = num (A - B u) conj(c) (QM31), its norm m and the
// product of the norms before it, in registers; one inverse of the
// chunk's product (37 products) then gives every 1/m by Montgomery's
// trick, 3 M31 products a pair, and f_b = t / m.  A zero den has m = 0
// and f_b = 0 (the ladder's inv(0) = 0, as the plain version has it):
// its m is replaced by 1 in the product chain and its inverse forced to
// 0, so one zero does not poison its chunk.
//
// Lazy products.  The kernel's QM31 and CM31 products sum the raw
// 64-bit products of each output coordinate (at most four, each below
// 2^62 for words below 2^31, p - y standing for -y) and reduce once;
// a single product folds once (below 2^62 it leaves at most 2p - 1).
// Against m31.cuh's products, which reduce every product twice, this
// is about half the instructions.
//
// Three passes, launched together:
//   1. one thread per row: every pair's fraction, the running sum S_b
//      stored for b < B-1, then a block-wide inclusive scan of the row
//      totals; each block writes its total to `scratch`;
//   2. one block scans the block totals (exclusive);
//   3. every row of the last column adds its block's offset.
// M31 addition is exact, so the order of the scan does not matter.
//
// Operands in M31 (modes 0 and 1) stay in M31 through the products: a
// product with one M31 factor is 4 M31 products, not a QM31 product, and
// a denominator pair in M31 is inverted in M31.  The branches depend on
// the pair only, so they are uniform across the warp.
//
// What bounds it on the H100: the operations, integer multiplies (which
// issue at half the float32 rate).  With M31 numerators and QM31
// denominators, per row and pair: two M31 x QM31 products, one QM31
// product, the norm and conjugate products, one more QM31 product, the
// 3 products of the batch and the 4 of t / m, and 1/kChunk of an M31
// inverse: about 390 32-bit operations in the count of chip_smoke.py
// `logup_ops` (750 with one QM31 inverse a pair and every product
// reduced), against at most 80 bytes moved.  The chunk is 8: at 16 the
// thread's t, m and prefixes leave room for one block an SM, and the
// kernel ran slower.
#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pairs a thread batches under one M31 inverse (air/component.py LOGUP_CHUNK)
constexpr int kChunk = 8;

// an operand as loaded: an M31 value in v.a (base) or a QM31
struct operand {
  qm31 v;
  bool base;
};

// operand (off, mode) of the table as copied into shared memory
__device__ __forceinline__ operand load_operand(const uint32_t* __restrict__ src,
                                                longlong2 om, long long row) {
  const long long off = om.x;
  switch (om.y) {
    case 0: return {{__ldg(src + off), 0u, 0u, 0u}, true};
    case 1: return {{__ldg(src + off + row), 0u, 0u, 0u}, true};
    case 2: return {{__ldg(src + off), __ldg(src + off + 1), __ldg(src + off + 2),
                     __ldg(src + off + 3)}, false};
    default: {
      const uint32_t* q = src + off + 4 * row;
      return {{__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3)}, false};
    }
  }
}

// Lazily reduced products: a sum of at most four products of words
// below 2^31 stays below 2^64 and is reduced once.
__device__ __forceinline__ uint64_t prod(uint32_t a, uint32_t b) {
  return (uint64_t)a * b;
}

// a * b for words below 2^31: the product is below 2^62, so one fold
// leaves at most 2p - 1 and one subtract makes it canonical
__device__ __forceinline__ uint32_t mul31(uint32_t a, uint32_t b) {
  const uint64_t t = prod(a, b);
  const uint32_t r = ((uint32_t)t & NZT_P) + (uint32_t)(t >> 31);
  return r >= NZT_P ? r - NZT_P : r;
}

// (A + B u)(C + D u) = A C + B (R D) + (A D + B C) u, each coordinate
// four products reduced once (p - y stands for -y)
__device__ __forceinline__ qm31 qmul(qm31 x, qm31 y) {
  const uint32_t z0 = m31_sub(m31_add(y.c, y.c), y.d);
  const uint32_t z1 = m31_add(m31_add(y.d, y.d), y.c);
  const uint32_t ny1 = NZT_P - y.b, ny3 = NZT_P - y.d, nz1 = NZT_P - z1;
  return {m31_reduce64(prod(x.a, y.a) + prod(x.b, ny1) + prod(x.c, z0) + prod(x.d, nz1)),
          m31_reduce64(prod(x.a, y.b) + prod(x.b, y.a) + prod(x.c, z1) + prod(x.d, z0)),
          m31_reduce64(prod(x.a, y.c) + prod(x.b, ny3) + prod(x.c, y.a) + prod(x.d, ny1)),
          m31_reduce64(prod(x.a, y.d) + prod(x.b, y.c) + prod(x.c, y.b) + prod(x.d, y.a))};
}

__device__ __forceinline__ qm31 qmul31(qm31 x, uint32_t s) {
  return {mul31(x.a, s), mul31(x.b, s), mul31(x.c, s), mul31(x.d, s)};
}

// x * y, in M31 where a factor is M31
__device__ __forceinline__ operand op_mul(operand x, operand y) {
  if (x.base && y.base) return {{mul31(x.v.a, y.v.a), 0u, 0u, 0u}, true};
  if (x.base) return {qmul31(y.v, x.v.a), false};
  if (y.base) return {qmul31(x.v, y.v.a), false};
  return {qmul(x.v, y.v), false};
}

__device__ __forceinline__ operand op_add(operand x, operand y) {
  if (x.base && y.base) return {{m31_add(x.v.a, y.v.a), 0u, 0u, 0u}, true};
  return {qm31_add(x.v, y.v), false};
}

__device__ __forceinline__ qm31 shfl_up(qm31 v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.a, d), __shfl_up_sync(0xffffffffu, v.b, d),
          __shfl_up_sync(0xffffffffu, v.c, d), __shfl_up_sync(0xffffffffu, v.d, d)};
}

// inclusive scan over the block (blockDim.x == kThreads); returns this
// thread's prefix and leaves the block total in *total
__device__ qm31 block_scan(qm31 v, qm31* total) {
  __shared__ qm31 warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    qm31 u = shfl_up(v, d);
    if (lane >= d) v = qm31_add(v, u);
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    qm31 w = lane < kWarps ? warp_sums[lane] : qm31{0u, 0u, 0u, 0u};
    for (int d = 1; d < kWarps; d <<= 1) {
      qm31 u = shfl_up(w, d);
      if (lane >= d) w = qm31_add(w, u);
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = qm31_add(v, warp_sums[warp - 1]);
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return v;
}

// the fraction's numerator over the norm of its denominator, t = num /
// den * m, and that norm m (a QM31 den: |A^2 - R B^2|^2; an M31 den:
// den); m = 0 exactly when den = 0
struct over_norm_t {
  qm31 t;
  uint32_t m;
};

__device__ __forceinline__ over_norm_t over_norm(operand num, operand den) {
  if (den.base) return {num.v, den.v.a};
  const uint32_t a0 = den.v.a, a1 = den.v.b, b0 = den.v.c, b1 = den.v.d;
  // A^2, B^2, c = A^2 - R B^2, m = |c|^2, (A - B u) conj(c)
  const uint32_t sa0 = m31_reduce64(prod(a0, a0) + prod(a1, NZT_P - a1));
  const uint32_t sa1 = m31_reduce64(2 * prod(a0, a1));
  const uint32_t sb0 = m31_reduce64(prod(b0, b0) + prod(b1, NZT_P - b1));
  const uint32_t sb1 = m31_reduce64(2 * prod(b0, b1));
  const cm31 c = cm31_sub({sa0, sa1}, cm31_mul_r({sb0, sb1}));
  const uint32_t m = m31_reduce64(prod(c.a, c.a) + prod(c.b, c.b));
  const uint32_t nc0 = NZT_P - c.a, nc1 = NZT_P - c.b;
  const qm31 adj = {m31_reduce64(prod(a0, c.a) + prod(a1, c.b)),
                    m31_reduce64(prod(a1, c.a) + prod(a0, nc1)),
                    m31_reduce64(prod(b0, nc0) + prod(b1, nc1)),
                    m31_reduce64(prod(b0, c.b) + prod(b1, nc0))};
  return {num.base ? qmul31(adj, num.v.a) : qmul(num.v, adj), m};
}

__global__ void __launch_bounds__(kThreads)
logup_rows(const uint32_t* __restrict__ src, const long long* __restrict__ meta,
           int B, long long M, uint32_t* __restrict__ out,
           uint32_t* __restrict__ scratch) {
  extern __shared__ longlong2 s_meta[];          // 4 B (off, mode)
  for (int i = threadIdx.x; i < 4 * B; i += kThreads)
    s_meta[i] = make_longlong2(meta[2 * i], meta[2 * i + 1]);
  __syncthreads();
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  qm31 s = {0u, 0u, 0u, 0u};
  if (row < M) {
    for (int b0 = 0; b0 < B; b0 += kChunk) {
      qm31 t[kChunk];
      uint32_t m[kChunk], before[kChunk];
      uint32_t chain = 1u;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int b = b0 + j;
        if (b < B) {
          const operand n1 = load_operand(src, s_meta[b], row);
          const operand d1 = load_operand(src, s_meta[B + b], row);
          const operand n2 = load_operand(src, s_meta[2 * B + b], row);
          const operand d2 = load_operand(src, s_meta[3 * B + b], row);
          const over_norm_t f =
              over_norm(op_add(op_mul(n1, d2), op_mul(n2, d1)), op_mul(d1, d2));
          t[j] = f.t;
          m[j] = f.m;
          before[j] = chain;
          chain = mul31(chain, m[j] ? m[j] : 1u);
        }
      }
      uint32_t inv = m31_inv(chain);            // 1 / (m_0 .. m_j), zeros as 1
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) {
        if (b0 + j < B) {
          const uint32_t mi = m[j] ? mul31(inv, before[j]) : 0u;
          inv = mul31(inv, m[j] ? m[j] : 1u);
          t[j] = qmul31(t[j], mi);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int b = b0 + j;
        if (b < B) {
          s = qm31_add(s, t[j]);
          if (b < B - 1) qm31_store(out + ((long long)b * M + row) * 4, s);
        }
      }
    }
  }
  qm31 total;
  const qm31 pre = block_scan(s, &total);
  if (row < M) qm31_store(out + ((long long)(B - 1) * M + row) * 4, pre);
  if (threadIdx.x == 0) qm31_store(scratch + 4 * (long long)blockIdx.x, total);
}

// exclusive scan of the n block totals, in place, by one block
__global__ void __launch_bounds__(kThreads)
logup_block_offsets(uint32_t* __restrict__ scratch, long long n) {
  qm31 carry = {0u, 0u, 0u, 0u};
  for (long long base = 0; base < n; base += kThreads) {
    const long long k = base + threadIdx.x;
    const qm31 v = k < n ? qm31_load(scratch + 4 * k) : qm31{0u, 0u, 0u, 0u};
    qm31 total;
    const qm31 inc = block_scan(v, &total);
    if (k < n) qm31_store(scratch + 4 * k, qm31_add(carry, qm31_sub(inc, v)));
    carry = qm31_add(carry, total);
  }
}

__global__ void __launch_bounds__(kThreads)
logup_add_offsets(uint32_t* __restrict__ last, long long M,
                  const uint32_t* __restrict__ scratch) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0 || row >= M) return;
  const qm31 off = qm31_load(scratch + 4 * (long long)blockIdx.x);
  qm31_store(last + 4 * row, qm31_add(qm31_load(last + 4 * row), off));
}

}  // namespace

// src/meta as above (meta on the card), out (B, M, 4), scratch
// (ceil(M / 256), 4).
extern "C" int nzt_logup_columns(const uint32_t* src, const long long* meta,
                                 int B, long long M, uint32_t* out,
                                 uint32_t* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kThreads - 1) / kThreads;
  const size_t smem = sizeof(longlong2) * 4 * (size_t)B;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(logup_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  logup_rows<<<(unsigned)blocks, kThreads, smem, st>>>(src, meta, B, M, out, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  logup_block_offsets<<<1, kThreads, 0, st>>>(scratch, blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  logup_add_offsets<<<(unsigned)blocks, kThreads, 0, st>>>(
      out + (long long)(B - 1) * M * 4, M, scratch);
  return (int)cudaGetLastError();
}

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
// Batched inversion and lazy products (qm31_lazy.cuh).  Every pair
// needs one M31 inverse: of the norm |c|^2 of its QM31 denominator, or of
// the denominator itself when it is M31.  A thread takes its row's pairs
// kChunk at a time: for each it keeps t = num (A - B u) conj(c) (QM31)
// and its norm m in registers; one inverse of the chunk's product (37
// products) then gives every 1/m by Montgomery's trick, 3 M31 products a
// pair, and f_b = t / m.  A zero den has m = 0 and f_b = 0 (the ladder's
// inv(0) = 0, as the plain version has it): its m is replaced by 1 in
// the product chain and its inverse forced to 0, so one zero does not
// poison its chunk.  The QM31 and CM31 products reduce each coordinate's
// raw 64-bit sum once, about half the instructions of m31.cuh's.
//
// Three passes, launched together:
//   1. one thread per row: every pair's fraction, the running sum S_b
//      stored for b < B-1, then a block-wide inclusive scan of the row
//      totals; each block writes its total to `scratch`;
//   2. one block scans the block totals (exclusive), starting from the
//      carry;
//   3. every row of the last column adds its block's offset.
// M31 addition is exact, so the order of the scan does not matter.
//
// The carry (a QM31 on the card, or none: zero) is where the last
// column's prefix sum starts: the sum of the row totals before these M
// rows.  A mesh rank that holds rows [lo, lo + M) of a component passes
// the totals of the ranks before it, so its rows equal those rows of the
// whole component's column.
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
#include "qm31_lazy.cuh"

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
  const norm_adj_t n = norm_adj(den.v);
  return {num.base ? qmul31(n.adj, num.v.a) : qmul(num.v, n.adj), n.m};
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
          before[j] = chain_push(chain, m[j]);
        }
      }
      uint32_t inv = m31_inv(chain);            // 1 / (m_0 .. m_j), zeros as 1
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j)
        if (b0 + j < B) t[j] = qmul31(t[j], chain_pop(inv, m[j], before[j]));
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

// exclusive scan of the n block totals from the carry (none: zero), in
// place, by one block
__global__ void __launch_bounds__(kThreads)
logup_block_offsets(uint32_t* __restrict__ scratch, long long n,
                    const uint32_t* __restrict__ start) {
  qm31 carry = start ? qm31_load(start) : qm31{0u, 0u, 0u, 0u};
  for (long long base = 0; base < n; base += kThreads) {
    const long long k = base + threadIdx.x;
    const qm31 v = k < n ? qm31_load(scratch + 4 * k) : qm31{0u, 0u, 0u, 0u};
    qm31 total;
    const qm31 inc = block_scan(v, &total);
    if (k < n) qm31_store(scratch + 4 * k, qm31_add(carry, qm31_sub(inc, v)));
    carry = qm31_add(carry, total);
  }
}

// block 0's offset is the carry: zero, and skipped, without one
__global__ void __launch_bounds__(kThreads)
logup_add_offsets(uint32_t* __restrict__ last, long long M,
                  const uint32_t* __restrict__ scratch, int first) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if ((int)blockIdx.x < first || row >= M) return;
  const qm31 off = qm31_load(scratch + 4 * (long long)blockIdx.x);
  qm31_store(last + 4 * row, qm31_add(qm31_load(last + 4 * row), off));
}

}  // namespace

// src/meta as above (meta on the card), out (B, M, 4), scratch
// (ceil(M / 256), 4), carry 4 words on the card or null.
extern "C" int nzt_logup_columns(const uint32_t* src, const long long* meta,
                                 int B, long long M, uint32_t* out,
                                 uint32_t* scratch, const uint32_t* carry,
                                 void* stream) {
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
  logup_block_offsets<<<1, kThreads, 0, st>>>(scratch, blocks, carry);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  logup_add_offsets<<<(unsigned)blocks, kThreads, 0, st>>>(
      out + (long long)(B - 1) * M * 4, M, scratch, carry ? 0 : 1);
  return (int)cudaGetLastError();
}

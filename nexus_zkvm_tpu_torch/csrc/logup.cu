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
// are read as they are: nothing is widened to (M, 4) first.
//
// Three passes, launched together:
//   1. one thread per row: every pair's fraction (the QM31 inverse by the
//      ladder stays in registers), the running sum S_b stored for b < B-1,
//      then a block-wide inclusive scan of the row totals; each block
//      writes its total to `scratch`;
//   2. one block scans the block totals (exclusive);
//   3. every row of the last column adds its block's offset.
// M31 addition is exact, so the order of the scan does not matter.
//
// Operands in M31 (modes 0 and 1) stay in M31 through the products: a
// product with one M31 factor is 4 M31 products, not a QM31 product, and
// a denominator pair in M31 is inverted in M31.  The branches depend on
// the pair only, so they are uniform across the warp.
//
// What bounds it on the H100: the operations.  With M31 numerators and
// QM31 denominators, per row and pair: two M31 x QM31 products, one QM31
// product, one QM31 inverse (an M31 inverse of 37 products plus CM31
// work), one more QM31 product and two adds, about 750 32-bit operations
// against at most 80 bytes moved.  The bound of one launch is counted
// from its operand modes (chip_smoke.py `logup_ops`).  Montgomery's
// batch inversion would trade most inverses for products, and is left
// for later.
#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// an operand as loaded: an M31 value in v.a (base) or a QM31
struct operand {
  qm31 v;
  bool base;
};

__device__ __forceinline__ operand load_operand(const uint32_t* __restrict__ src,
                                                const long long* __restrict__ meta,
                                                int slot, long long row) {
  const long long off = __ldg(meta + 2 * slot);
  const long long mode = __ldg(meta + 2 * slot + 1);
  switch (mode) {
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
  if (x.base && y.base) return {{m31_mul(x.v.a, y.v.a), 0u, 0u, 0u}, true};
  if (x.base) return {qm31_mul_m31(y.v, x.v.a), false};
  if (y.base) return {qm31_mul_m31(x.v, y.v.a), false};
  return {qm31_mul(x.v, y.v), false};
}

__device__ __forceinline__ operand op_add(operand x, operand y) {
  if (x.base && y.base) return {{m31_add(x.v.a, y.v.a), 0u, 0u, 0u}, true};
  return {qm31_add(x.v, y.v), false};
}

__device__ __forceinline__ operand op_inv(operand x) {
  if (x.base) return {{m31_inv(x.v.a), 0u, 0u, 0u}, true};
  return {qm31_inv(x.v), false};
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

__global__ void __launch_bounds__(kThreads)
logup_rows(const uint32_t* __restrict__ src, const long long* __restrict__ meta,
           int B, long long M, uint32_t* __restrict__ out,
           uint32_t* __restrict__ scratch) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  qm31 s = {0u, 0u, 0u, 0u};
  if (row < M) {
    for (int b = 0; b < B; ++b) {
      const operand n1 = load_operand(src, meta, b, row);
      const operand d1 = load_operand(src, meta, B + b, row);
      const operand n2 = load_operand(src, meta, 2 * B + b, row);
      const operand d2 = load_operand(src, meta, 3 * B + b, row);
      const operand num = op_add(op_mul(n1, d2), op_mul(n2, d1));
      s = qm31_add(s, op_mul(num, op_inv(op_mul(d1, d2))).v);
      if (b < B - 1) qm31_store(out + ((long long)b * M + row) * 4, s);
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

// src/meta as above, out (B, M, 4), scratch (ceil(M / 256), 4).
extern "C" int nzt_logup_columns(const uint32_t* src, const long long* meta,
                                 int B, long long M, uint32_t* out,
                                 uint32_t* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (M + kThreads - 1) / kThreads;
  logup_rows<<<(unsigned)blocks, kThreads, 0, st>>>(src, meta, B, M, out, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  logup_block_offsets<<<1, kThreads, 0, st>>>(scratch, blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  logup_add_offsets<<<(unsigned)blocks, kThreads, 0, st>>>(
      out + (long long)(B - 1) * M * 4, M, scratch);
  return (int)cudaGetLastError();
}

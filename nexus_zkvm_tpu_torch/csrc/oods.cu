// K8: out-of-domain samples of coefficient rows at QM31 points, every
// (role, size, offset) group of a proof's OODS phase in one launch.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/prover/
// stark.py `_oods_dot` (:176, body `_oods_dot_body` :167) and
// `_oods_dot_factored` (:197), which the reference issues once a group
// (:905-925).  For a group's rows x (2^n bit-reversed circle
// coefficients each) and its point's factors f_0 .. f_{n-1},
//   out[r] = sum_j x[r, j] * basis[j]                   (QM31)
// where basis[j] is the product of f_i over the set bits i of j (the
// Kron basis, `_oods_basis_factors` :180).  With j = lo + 2^k hi,
//   basis[j] = B_lo[lo] * B_hi[hi],
//   out[r]   = sum_lo B_lo[lo] * (sum_hi x[r, lo + 2^k hi] * B_hi[hi]).
// A thread keeps its lo words fixed and sums over hi: x * B_hi[hi] is an
// M31 x QM31 product, four widening multiply-adds into four uint64 sums
// and no reduction; B_hi[hi] is one broadcast read for the whole block.
// Each sum is reduced and multiplied by B_lo[lo] (QM31) once, at the end
// of a unit of work.
//
// Lazy sums.  Every coefficient word is at most p (p itself, a
// non-canonical zero, may occur) and every basis word at most p - 1 (the
// tables are formed here, canonical).  A fold s -> (s mod 2^32) + 2 (s >>
// 32), exact mod p since 2^32 = 2 (mod p), leaves s < 3 * 2^32, and four
// products add at most 4 p (p - 1) < 2^64 - 6 * 2^32.  So a sum folded
// after every 4 words never wraps (tests/test_torch_oods_logup.py checks
// it at words of p - 1 and p).
//
// Work.  `prover/stark.py` `oods_plan` writes a descriptor a group
// (fields D_* below): the base pointer of the role's coefficient batch
// (rows are read where they lie: no gather), its row-index list (whose
// offset is also the group's first output row), n, the
// lo/hi split k = min(n, kLoBits), the unit shape (R rows of H high
// indices: H up to the plan's chunk when the row is long, R rows packed
// into the block's 2^kLoBits words when it is short), the group's first
// unit and basis entry, and its factors.  Groups are in launch
// order, the largest units first.  Three passes, launched together:
//   1. every group's B_lo and B_hi, one thread an entry, into `basis`;
//   2. a persistent grid (as many blocks as fit on the card at once, so
//      no partial wave trails) takes units from a counter, largest first;
//      thread t of a block owns words w = t + 256 i (i < kPer) of each
//      step, row w >> k and lo = w mod 2^k of the unit, and loads kStep
//      steps at once; a unit's row sums go through warp shuffles to
//      uint64 atomics, one a (warp, row, coordinate);
//   3. the uint64 sums are reduced to words.
//
// What bounds it on the H100: the bytes (every coefficient word read
// once; 4 multiply-adds a word and a fold every 4 words, ~0.13 ms at the
// integer rate for 2^28 words against the 0.305 ms to read them).
// On the H100, 4 words a thread (kLoBits 10) ran faster than 8, whose
// sums spilled, and loading 8 steps at once faster than 4; loading the
// next steps ahead of the sums, in more registers, was slower.
#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoBits = 10;              // 2^kLoBits words a step: kPer a thread
constexpr int kPer = (1 << kLoBits) / kThreads;
constexpr int kStep = 8;                 // high indices loaded together
// descriptor fields, int64 each (`prover/stark.py` OODS_FIELDS)
enum { D_BASE, D_ROWS, D_NROWS, D_LOGN, D_K, D_R, D_H, D_NCHUNK, D_UNIT0,
       D_BASIS, D_FACT, D_FIELDS };

__device__ __forceinline__ qm31 shfl_down(qm31 v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.a, d), __shfl_down_sync(0xffffffffu, v.b, d),
          __shfl_down_sync(0xffffffffu, v.c, d), __shfl_down_sync(0xffffffffu, v.d, d)};
}

__device__ __forceinline__ qm31 qm31_ldg(const uint32_t* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return {v.x, v.y, v.z, v.w};
}

// s mod p unchanged, s < 3 * 2^32 after
__device__ __forceinline__ uint64_t fold(uint64_t s) {
  return (uint64_t)(uint32_t)s + 2ull * (s >> 32);
}

// the last group (launch order) whose field f is <= v; f ascends
__device__ __forceinline__ const long long* find_group(
    const long long* __restrict__ desc, int G, int f, long long v) {
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(desc + (long long)mid * D_FIELDS + f) <= v) lo = mid;
    else hi = mid - 1;
  }
  return desc + (long long)lo * D_FIELDS;
}

// entry e of the concatenated tables: a group's 2^k B_lo entries, then
// its 2^(n - k) B_hi entries, each the product of its factors over the
// set bits of its index
__global__ void oods_basis(const long long* __restrict__ desc, int G,
                           const long long* __restrict__ factors, long long E,
                           uint32_t* __restrict__ basis) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long* d = find_group(desc, G, D_BASIS, e);
  const int k = (int)d[D_K];
  long long idx = e - d[D_BASIS];
  int f0 = 0, nbits = k;
  if (idx >= (1ll << k)) {
    idx -= 1ll << k;
    f0 = k;
    nbits = (int)d[D_LOGN] - k;
  }
  const long long* f = factors + d[D_FACT] + 4 * f0;
  qm31 acc = {1u, 0u, 0u, 0u};
  for (int b = 0; b < nbits; ++b)
    if ((idx >> b) & 1)
      acc = qm31_mul(acc, {(uint32_t)f[4 * b], (uint32_t)f[4 * b + 1],
                           (uint32_t)f[4 * b + 2], (uint32_t)f[4 * b + 3]});
  qm31_store(basis + 4 * e, acc);
}

// the words of high indices h .. h + kStep - 1 (0 past H or off the
// unit's rows) and their B_hi entries
__device__ __forceinline__ void load_step(uint32_t (&x)[kStep][kPer], qm31 (&b)[kStep],
                                          const uint32_t* const (&xs)[kPer],
                                          const bool (&on)[kPer],
                                          const uint32_t* bhi, int h, int H, int k) {
#pragma unroll
  for (int j = 0; j < kStep; ++j) {
    const bool in = h + j < H;
    b[j] = in ? qm31_ldg(bhi + 4 * (h + j)) : qm31{0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      x[j][i] = in && on[i] ? __ldg(xs[i] + ((long long)(h + j) << k)) : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
oods_units(const long long* __restrict__ desc, int G,
           const long long* __restrict__ rows,
           const uint32_t* __restrict__ basis, long long U,
           unsigned long long* __restrict__ counter,
           unsigned long long* __restrict__ acc) {
  __shared__ long long s_unit;
  const int t = threadIdx.x;
  for (;;) {
    if (t == 0) s_unit = (long long)atomicAdd(counter, 1ull);
    __syncthreads();
    const long long u = s_unit;
    __syncthreads();
    if (u >= U) return;
    const long long* d = find_group(desc, G, D_UNIT0, u);
    const int log_n = (int)d[D_LOGN], k = (int)d[D_K], H = (int)d[D_H];
    const long long nchunk = d[D_NCHUNK], loc = u - d[D_UNIT0];
    const long long r0 = loc / nchunk * d[D_R];
    const long long rows_here = min(d[D_R], d[D_NROWS] - r0);
    const long long h0 = loc % nchunk * H;
    const uint32_t* base = reinterpret_cast<const uint32_t*>(d[D_BASE]);
    const long long* rix = rows + d[D_ROWS] + r0;
    const uint32_t* bhi = basis + 4 * (d[D_BASIS] + (1ll << k) + h0);
    const uint32_t* xs[kPer];
    int rl[kPer], lo[kPer];
    bool on[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int w = t + kThreads * i;
      rl[i] = w >> k;
      lo[i] = w & ((1 << k) - 1);
      on[i] = rl[i] < rows_here;
      xs[i] = base + (on[i] ? (__ldg(rix + rl[i]) << log_n) + (h0 << k) + lo[i]
                            : 0ll);
    }
    uint64_t s[kPer][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0;
    uint32_t x[kStep][kPer];
    qm31 b[kStep];
    load_step(x, b, xs, on, bhi, 0, H, k);
    for (int h = 0; h < H; h += kStep) {
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          s[i][0] += (uint64_t)x[j][i] * b[j].a;
          s[i][1] += (uint64_t)x[j][i] * b[j].b;
          s[i][2] += (uint64_t)x[j][i] * b[j].c;
          s[i][3] += (uint64_t)x[j][i] * b[j].d;
        }
        if (j % 4 == 3 || j == kStep - 1) {
#pragma unroll
          for (int i = 0; i < kPer; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[i][c] = fold(s[i][c]);
        }
      }
      if (h + kStep < H) load_step(x, b, xs, on, bhi, h + kStep, H, k);
    }
    // the unit's row sums: a thread's slots of one row first (for k >= 8
    // slot i lies in row i >> (k - 8), the same for every thread), then
    // the warp's lanes of that row (2^k of them when k < 5), then one
    // uint64 atomic a coordinate
    qm31 run = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (on[i]) {
        const qm31 inner = {m31_reduce64(s[i][0]), m31_reduce64(s[i][1]),
                            m31_reduce64(s[i][2]), m31_reduce64(s[i][3])};
        run = qm31_add(run, qm31_mul(inner, qm31_ldg(basis + 4 * (d[D_BASIS] + lo[i]))));
      }
      if (i == kPer - 1 || k < 8 || ((i + 1) >> (k - 8)) != (i >> (k - 8))) {
        const int seg = k < 5 ? 1 << k : 32;
        for (int dd = seg >> 1; dd > 0; dd >>= 1)
          run = qm31_add(run, shfl_down(run, dd));
        if ((t & (seg - 1)) == 0 && on[i]) {
          unsigned long long* o = acc + 4 * (d[D_ROWS] + r0 + rl[i]);
          atomicAdd(o, (unsigned long long)run.a);
          atomicAdd(o + 1, (unsigned long long)run.b);
          atomicAdd(o + 2, (unsigned long long)run.c);
          atomicAdd(o + 3, (unsigned long long)run.d);
        }
        run = {0u, 0u, 0u, 0u};
      }
    }
  }
}

__global__ void oods_reduce(const unsigned long long* __restrict__ acc,
                            long long n, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = m31_reduce64(acc[i]);
}

// as many blocks as fit on the card at once, at most one a unit
int units_grid(long long U, long long* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, oods_units,
                                                      kThreads, 0);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = U < resident ? U : resident;
  return (int)e;
}

}  // namespace

// desc (G, D_FIELDS) in launch order, rows and factors (each u32 word as
// an int64) as `oods_plan` lays them out; E basis entries and U units in
// all; lo_bits must be kLoBits (the plan's split); basis (E, 4) scratch;
// acc (1 + 4 n_out) uint64 scratch, the counter first; out (n_out, 4).
extern "C" int nzt_oods_dot(const long long* desc, int G, const long long* rows,
                            const long long* factors, long long E, long long U,
                            int lo_bits, uint32_t* basis,
                            unsigned long long* acc, long long n_out,
                            uint32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0 || E <= 0 || U <= 0 || n_out <= 0 || lo_bits != kLoBits)
    return (int)cudaErrorInvalidValue;
  long long grid = 0;
  cudaError_t e = (cudaError_t)units_grid(U, &grid);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(acc, 0, (1 + 4 * n_out) * sizeof(*acc), st);
  if (e != cudaSuccess) return (int)e;
  oods_basis<<<(unsigned)((E + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      desc, G, factors, E, basis);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  oods_units<<<(unsigned)grid, kThreads, 0, st>>>(desc, G, rows, basis, U, acc,
                                                  acc + 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = 4 * n_out;
  oods_reduce<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      acc + 1, n, out);
  return (int)cudaGetLastError();
}

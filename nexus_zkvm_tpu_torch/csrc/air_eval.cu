// K7: a component's constraint tape over the rows of its domain.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/air/
// component.py `run_constraints_domain` (:601, launched from
// `_composition_coeffs_fused` prover/stark.py:364 through aot_call :484),
// its row-chunked form `run_constraints_domain_chunked` (:739, aot_call
// :780, the `domscan` program, with `ChunkedDomainEvalContext` :641) and
// the evaluate() part of `_gen_interaction_body` (:346, launched through
// `generate_interaction` :407).  Each runs a component's evaluate() over
// rows of its domain; here evaluate() has been recorded once on the host
// as an M31 program (nexus_zkvm_tpu_torch/air/tape.py), and one thread
// per row interprets it.
//
// The program: an int4 per instruction, (opcode, dst, a, b), read by
// every thread of the grid at the same address (a broadcast from L1).
// An operand word holds its kind in bits 30-31: 0 a slot (a value this
// thread computed earlier), 1 an entry of the uniform table (values
// shared by every row: constants, the relations' z and alpha powers, the
// claimed sum and what the host derived from them), 2 a load.  Load i
// of thread t reads column address tab[i] at position t + hneg + tab[L +
// i] under a mask: a mask offset of a trace row is a shift of 4 rows on
// the 4x evaluation domain.
// Opcodes: add, sub, mul, neg into a slot; emit1 (an M31 constraint) and
// emitq_lo / emitq_hi (a QM31 constraint, two coordinates each), which
// add w * c to the accumulator, w = alpha^(K-1-j) the weight of
// constraint j, four table words at the index in the instruction's dst
// field (so sum_j w_j c_j is the verifier's Horner sum; an M31
// constraint costs four products, not a QM31 one); store, which writes
// an operand to out[base + stride * row] (stride 0: a word shared by
// every row, written once by row 0).
//
// Slots: the host orders the program depth-first from each output and
// assigns slots by liveness (the CPU component: 6,802 instructions, 78
// slots; keccak: 53,713 and 450).  A block keeps its threads' slots in
// dynamic shared memory, slot-major ([slot][thread], so a warp's accesses
// fall in 32 distinct banks); the wrapper picks 128, 64 or 32 threads so
// that they fit, and refuses a tape whose slots do not fit at 32.  The
// next instruction is loaded while one runs.
//
// Two epilogues, two entry points:
//   composition: rows [lo, lo + L) of the 4x domain, bucket[row] += acc *
//     invv[row] * shift (QM31; bucket and invv are the whole domain's, the
//     bucket the (N, 4) sum of every component of this eval size).  The
//     columns are halo-extended natural blocks: position q of a block
//     holds natural row lo - hneg + q (mod N), so the thread of row lo + t
//     reads position t + hneg + shift with no wrap (the host built the
//     wrap into the blocks).  A resident composition is the one window
//     [0, N); the large-trace memory mode runs several;
//   operands: the stores write the (n1, d1, n2, d2) operands of every
//     LogUp pair into K6's packed buffer; loads read the trace's own
//     columns at (row + shift) mod N, N a power of two (the wrap is the
//     roll of the reference).
//
// What bounds it on the H100: the operations.  The interpreter spends
// about ten 32-bit lane instructions on the decode and operand fetch of
// each M31 operation besides the operation itself (6 for a product, 3
// for an add); the bound counts only the field operations (chip_smoke.py
// `tape_cost`).  Loads coalesce (consecutive rows of one column) and hit
// L1/L2 when a column is read again.
#include "m31.cuh"

namespace {

enum : int { kAdd = 0, kSub, kMul, kNeg, kEmit1, kEmitQLo, kEmitQHi, kStore };

struct Ctx {
  const long long* __restrict__ tab;  // [load addresses | shifts | uniforms]
  int n_loads;
  long long at, mask;                 // a load reads (at + shift) & mask
  uint32_t* slots;                    // this thread's slot 0 (shared)
  int sstride;                        // words between its slots
};

__device__ __forceinline__ uint32_t fetch(const Ctx& c, int w) {
  const unsigned kind = (unsigned)w >> 30;
  const int idx = w & 0x3fffffff;
  if (kind == 0) return c.slots[idx * c.sstride];
  if (kind == 1) return (uint32_t)__ldg(c.tab + 2 * c.n_loads + idx);
  const uint32_t* col = (const uint32_t*)__ldg(c.tab + idx);
  return __ldg(col + ((c.at + __ldg(c.tab + c.n_loads + idx)) & c.mask));
}

__device__ __forceinline__ qm31 weight(const Ctx& c, int at) {
  const long long* w = c.tab + 2 * c.n_loads + at;
  return {(uint32_t)__ldg(w), (uint32_t)__ldg(w + 1), (uint32_t)__ldg(w + 2),
          (uint32_t)__ldg(w + 3)};
}

// Thread t evaluates domain row row0 + t (t < N); its loads read at
// (t + hneg + shift) & mask (the operands' N - 1 wraps the domain; the
// composition's all-ones reads its halo-extended blocks as they are).
template <bool kCompose>
__global__ void air_eval(const int4* __restrict__ prog, int n_instr,
                         const long long* __restrict__ tab, int n_loads,
                         long long N, long long row0, long long hneg,
                         long long mask, qm31 shift,
                         const uint32_t* __restrict__ invv,
                         uint32_t* __restrict__ bucket,
                         const long long* __restrict__ stores,
                         uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N) return;  // no block-wide synchronisation below
  const long long row = row0 + t;
  Ctx c{tab, n_loads, t + hneg, mask, smem + threadIdx.x, (int)blockDim.x};
  qm31 acc = {0u, 0u, 0u, 0u}, e = {0u, 0u, 0u, 0u};
  int4 in = __ldg(prog);
  for (int i = 0; i < n_instr; ++i) {
    // the next instruction's load is in flight while this one runs
    const int4 next = __ldg(prog + min(i + 1, n_instr - 1));
    const uint32_t x = fetch(c, in.z);
    switch (in.x) {
      case kAdd: c.slots[in.y * c.sstride] = m31_add(x, fetch(c, in.w)); break;
      case kSub: c.slots[in.y * c.sstride] = m31_sub(x, fetch(c, in.w)); break;
      case kMul: c.slots[in.y * c.sstride] = m31_mul(x, fetch(c, in.w)); break;
      case kNeg: c.slots[in.y * c.sstride] = m31_neg(x); break;
      case kEmit1:
        acc = qm31_add(acc, qm31_mul_m31(weight(c, in.y), x));
        break;
      case kEmitQLo:
        e.a = x;
        e.b = fetch(c, in.w);
        break;
      case kEmitQHi:
        e.c = x;
        e.d = fetch(c, in.w);
        acc = qm31_add(acc, qm31_mul(weight(c, in.y), e));
        break;
      default: {  // kStore
        const long long base = __ldg(stores + 2 * in.y);
        const long long step = __ldg(stores + 2 * in.y + 1);
        if (step != 0 || row == 0) out[base + step * row] = x;
      }
    }
    in = next;
  }
  if (kCompose) {
    const qm31 d = qm31_mul(qm31_mul_m31(acc, __ldg(invv + row)), shift);
    uint32_t* b = bucket + 4 * row;
    qm31_store(b, qm31_add(qm31_load(b), d));
  }
}

template <bool kCompose>
int launch(const int4* prog, int n_instr, const long long* tab, int n_loads,
           long long N, long long row0, long long hneg, long long mask,
           int threads, int smem, qm31 shift, const uint32_t* invv,
           uint32_t* bucket, const long long* stores, uint32_t* out,
           cudaStream_t st) {
  if (n_instr <= 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        air_eval<kCompose>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (N + threads - 1) / threads;
  air_eval<kCompose><<<(unsigned)blocks, threads, smem, st>>>(
      prog, n_instr, tab, n_loads, N, row0, hneg, mask, shift, invv, bucket,
      stores, out);
  return (int)cudaGetLastError();
}

}  // namespace

// prog (n_instr, 4) int32; tab int64 [n_loads addresses | n_loads shifts |
// uniforms | constraint weights, 4 words each]; threads per block and
// shared bytes (slots * threads * 4) from the wrapper; rows [lo, lo + L)
// of the domain, tab's load addresses pointing into halo-extended blocks
// (row stride L + hneg + hpos); shift QM31 words; invv (N,) and bucket
// (N, 4), added to, the whole domain's.
extern "C" int nzt_air_eval_composition(
    const int* prog, int n_instr, const long long* tab, int n_loads,
    long long lo, long long L, long long hneg, int threads, int smem,
    uint32_t s0, uint32_t s1, uint32_t s2, uint32_t s3, const uint32_t* invv,
    uint32_t* bucket, void* stream) {
  if (lo < 0 || L <= 0 || hneg < 0) return (int)cudaErrorInvalidValue;
  return launch<true>((const int4*)prog, n_instr, tab, n_loads, L, lo, hneg,
                      -1LL, threads, smem, {s0, s1, s2, s3}, invv, bucket,
                      nullptr, nullptr, (cudaStream_t)stream);
}

// as above, tab without weights; stores (S, 2) int64 word base and row
// stride; out the packed operand buffer of K6.
extern "C" int nzt_air_eval_operands(const int* prog, int n_instr,
                                     const long long* tab, int n_loads,
                                     long long N, int threads, int smem,
                                     const long long* stores, uint32_t* out,
                                     void* stream) {
  const qm31 zero = {0u, 0u, 0u, 0u};
  return launch<false>((const int4*)prog, n_instr, tab, n_loads, N, 0, 0,
                       N - 1, threads, smem, zero, nullptr, nullptr, stores,
                       out, (cudaStream_t)stream);
}

// Lazily reduced M31 / QM31 products and the zero-safe batched inverse,
// shared by K3 and K12 (quotients.cu) and K6 (logup.cu).
//
// Lazy products.  A QM31 or CM31 product sums the raw 64-bit products of
// each output coordinate (at most four, each below 2^62 for words below
// 2^31, p - y standing for -y) and reduces once; a single product folds
// once (below 2^62 it leaves at most 2p - 1).  Against m31.cuh's
// products, which reduce every product twice, this is about half the
// instructions.
//
// Batched inversion (Montgomery's trick).  1/den of a QM31 den = A + B u
// is (A - B u) conj(c) / |c|^2 with c = A^2 - R B^2 (CM31) and |c|^2 in
// M31, so n denominators need n M31 norms and one M31 inverse of their
// product: each 1/m_j is (1 / (m_0 .. m_j)) (m_0 .. m_{j-1}), 3 products
// a value.  The norm is 0 exactly when den is 0; such an m is replaced by
// 1 in the product chain and its inverse forced to 0, which is the
// ladder's inv(0) = 0 of the plain versions, and one zero does not poison
// the rest of its batch.
#pragma once

#include "m31.cuh"

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

// den = A + B u as (A - B u) conj(c) / m: adj = (A - B u) conj(c) and the
// norm m = |c|^2, c = A^2 - R B^2; m = 0 exactly when den = 0
struct norm_adj_t {
  qm31 adj;
  uint32_t m;
};

__device__ __forceinline__ norm_adj_t norm_adj(qm31 den) {
  const uint32_t a0 = den.a, a1 = den.b, b0 = den.c, b1 = den.d;
  // A^2, B^2, c = A^2 - R B^2, m = |c|^2, (A - B u) conj(c)
  const uint32_t sa0 = m31_reduce64(prod(a0, a0) + prod(a1, NZT_P - a1));
  const uint32_t sa1 = m31_reduce64(2 * prod(a0, a1));
  const uint32_t sb0 = m31_reduce64(prod(b0, b0) + prod(b1, NZT_P - b1));
  const uint32_t sb1 = m31_reduce64(2 * prod(b0, b1));
  const cm31 c = cm31_sub({sa0, sa1}, cm31_mul_r({sb0, sb1}));
  const uint32_t m = m31_reduce64(prod(c.a, c.a) + prod(c.b, c.b));
  const uint32_t nc0 = NZT_P - c.a, nc1 = NZT_P - c.b;
  return {{m31_reduce64(prod(a0, c.a) + prod(a1, c.b)),
           m31_reduce64(prod(a1, c.a) + prod(a0, nc1)),
           m31_reduce64(prod(b0, nc0) + prod(b1, nc1)),
           m31_reduce64(prod(b0, c.b) + prod(b1, nc0))},
          m};
}

// Montgomery's trick a step at a time, so a caller can push each norm
// as it forms it: `chain_push` multiplies m into the chain (a zero as 1)
// and returns the product before it; after inv = m31_inv(chain),
// `chain_pop` in reverse order returns 1 / m (0 for m = 0) and takes m
// out of inv.
__device__ __forceinline__ uint32_t chain_push(uint32_t& chain, uint32_t m) {
  const uint32_t before = chain;
  chain = mul31(chain, m ? m : 1u);
  return before;
}

__device__ __forceinline__ uint32_t chain_pop(uint32_t& inv, uint32_t m,
                                              uint32_t before) {
  const uint32_t r = m ? mul31(inv, before) : 0u;
  inv = mul31(inv, m ? m : 1u);
  return r;
}

// m[j] <- 1 / m[j] (a zero stays zero), by one M31 inverse
template <int N>
__device__ __forceinline__ void invert_batch(uint32_t (&m)[N]) {
  uint32_t before[N];
  uint32_t chain = 1u;
#pragma unroll
  for (int j = 0; j < N; ++j) before[j] = chain_push(chain, m[j]);
  uint32_t inv = m31_inv(chain);
#pragma unroll
  for (int j = N - 1; j >= 0; --j) m[j] = chain_pop(inv, m[j], before[j]);
}

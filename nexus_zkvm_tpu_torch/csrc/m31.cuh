// M31 / CM31 / QM31 device arithmetic shared by the kernels.
//
// p = 2^31 - 1.  Values are canonical uint32 in [0, p).  A product is
// one widening 32x32 -> 64-bit multiply and a Mersenne reduction:
// 2^31 = 1 (mod p), so t = hi * 2^31 + lo folds to hi + lo.  Two folds
// bring any 64-bit t to at most p + 5, and one conditional subtract
// makes it canonical.  The subtract is not optional: (p - 1)^2 folded
// once gives 2^31 = p + 1.
//
// CM31 = M31[i]/(i^2 + 1); QM31 = CM31[u]/(u^2 - (2 + i)), stored as
// four words (a + b i) + (c + d i) u, the layout of the Python side.
//
// Under NZT_HOST (host_shim.h) the same functions compile as plain C++.
#pragma once

#include <cstdint>
#ifndef NZT_HOST
#include <cuda_runtime.h>
#endif

#define NZT_P 0x7fffffffu

__device__ __forceinline__ uint32_t m31_reduce64(uint64_t t) {
  uint64_t r = (t & NZT_P) + (t >> 31);
  r = (r & NZT_P) + (r >> 31);
  uint32_t v = (uint32_t)r;
  return v >= NZT_P ? v - NZT_P : v;
}

__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s >= NZT_P ? s - NZT_P : s;
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  uint32_t d = a + (NZT_P - b);
  return d >= NZT_P ? d - NZT_P : d;
}

__device__ __forceinline__ uint32_t m31_neg(uint32_t a) {
  return a == 0 ? 0u : NZT_P - a;
}

__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
  return m31_reduce64((uint64_t)a * (uint64_t)b);
}

__device__ __forceinline__ uint32_t m31_sqn(uint32_t x, int n) {
  for (int i = 0; i < n; ++i) x = m31_mul(x, x);
  return x;
}

// x^(p-2) by the x^(2^k - 1) ladder (37 multiplies); inv(0) = 0.
__device__ __forceinline__ uint32_t m31_inv(uint32_t x) {
  uint32_t t1 = m31_mul(m31_sqn(x, 1), x);        // x^(2^2 - 1)
  uint32_t t2 = m31_mul(m31_sqn(t1, 1), x);       // x^(2^3 - 1)
  uint32_t t3 = m31_mul(m31_sqn(t2, 3), t2);      // x^(2^6 - 1)
  uint32_t t4 = m31_mul(m31_sqn(t3, 6), t3);      // x^(2^12 - 1)
  uint32_t t5 = m31_mul(m31_sqn(t4, 12), t4);     // x^(2^24 - 1)
  uint32_t t6 = m31_mul(m31_sqn(t5, 3), t2);      // x^(2^27 - 1)
  uint32_t t7 = m31_mul(m31_sqn(t6, 2), t1);      // x^(2^29 - 1)
  return m31_mul(m31_sqn(t7, 2), x);              // x^(2^31 - 3)
}

struct cm31 {
  uint32_t a, b;
};

struct qm31 {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ cm31 cm31_add(cm31 x, cm31 y) {
  return {m31_add(x.a, y.a), m31_add(x.b, y.b)};
}

__device__ __forceinline__ cm31 cm31_sub(cm31 x, cm31 y) {
  return {m31_sub(x.a, y.a), m31_sub(x.b, y.b)};
}

__device__ __forceinline__ cm31 cm31_mul(cm31 x, cm31 y) {
  return {m31_sub(m31_mul(x.a, y.a), m31_mul(x.b, y.b)),
          m31_add(m31_mul(x.a, y.b), m31_mul(x.b, y.a))};
}

// multiply by R = 2 + i
__device__ __forceinline__ cm31 cm31_mul_r(cm31 x) {
  return {m31_sub(m31_add(x.a, x.a), x.b), m31_add(m31_add(x.b, x.b), x.a)};
}

__device__ __forceinline__ cm31 cm31_inv(cm31 x) {
  uint32_t ninv = m31_inv(m31_add(m31_mul(x.a, x.a), m31_mul(x.b, x.b)));
  return {m31_mul(x.a, ninv), m31_mul(m31_neg(x.b), ninv)};
}

__device__ __forceinline__ qm31 qm31_add(qm31 x, qm31 y) {
  return {m31_add(x.a, y.a), m31_add(x.b, y.b), m31_add(x.c, y.c),
          m31_add(x.d, y.d)};
}

__device__ __forceinline__ qm31 qm31_sub(qm31 x, qm31 y) {
  return {m31_sub(x.a, y.a), m31_sub(x.b, y.b), m31_sub(x.c, y.c),
          m31_sub(x.d, y.d)};
}

__device__ __forceinline__ qm31 qm31_mul_m31(qm31 x, uint32_t s) {
  return {m31_mul(x.a, s), m31_mul(x.b, s), m31_mul(x.c, s), m31_mul(x.d, s)};
}

// (A + B u)(C + D u) = AC + R BD + (AD + BC) u
__device__ __forceinline__ qm31 qm31_mul(qm31 x, qm31 y) {
  cm31 xa = {x.a, x.b}, xb = {x.c, x.d}, ya = {y.a, y.b}, yb = {y.c, y.d};
  cm31 lo = cm31_add(cm31_mul(xa, ya), cm31_mul_r(cm31_mul(xb, yb)));
  cm31 hi = cm31_add(cm31_mul(xa, yb), cm31_mul(xb, ya));
  return {lo.a, lo.b, hi.a, hi.b};
}

// 1/(A + B u) = (A - B u) / (A^2 - R B^2)
__device__ __forceinline__ qm31 qm31_inv(qm31 x) {
  cm31 xa = {x.a, x.b}, xb = {x.c, x.d};
  cm31 dinv = cm31_inv(cm31_sub(cm31_mul(xa, xa), cm31_mul_r(cm31_mul(xb, xb))));
  cm31 lo = cm31_mul(xa, dinv);
  cm31 hi = cm31_mul({m31_neg(xb.a), m31_neg(xb.b)}, dinv);
  return {lo.a, lo.b, hi.a, hi.b};
}

__device__ __forceinline__ qm31 qm31_load(const uint32_t* p) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ void qm31_store(uint32_t* p, qm31 v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.a, v.b, v.c, v.d);
}

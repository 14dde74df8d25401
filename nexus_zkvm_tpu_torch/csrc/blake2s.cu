// K2: Blake2s-256 compression for Merkle leaves and parent layers.
//
// Replaces the JAX package's device programs nexus_zkvm_tpu/ops/blake2s.py
// `_batch_blake2s_words` (:158), run for every Merkle leaf layer and FRI
// layer, and the Merkle climb nexus_zkvm_tpu/ops/merkle.py `_climb_block`
// (:135) / nexus_zkvm_tpu/ops/fri.py `climb` (:303), which hashes 16-word
// child pairs up to the root.
//
// One thread per message: the 16-word state and the 16-word block stay
// in registers; 10 rounds of 8 G mixes are fully unrolled with the
// message schedule written out, so every index is a compile-time
// constant.  A W-word message is zero-padded to 16-word blocks; the byte
// counter is 64 (i + 1) for block i and 4 W for the last, which also
// sets the final-block flag.
//
// Entry points:
//   nzt_blake2s_messages: message r is element (r, w) at
//     in[r * stride_r + w * stride_w], so a (C, N) column matrix is hashed
//     leaf-wise (stride_r = 1, stride_w = N: neighbouring threads read
//     neighbouring words) and an (R, W) row matrix row-wise.
//   nzt_blake2s_parents: (2R, 8) child digests -> (R, 8), 16-byte loads.
//
// What bounds it on the H100: 32-bit integer issue.  A compression is
// 80 G mixes of 12 instructions (two three-input adds, two adds, four
// xors, four rotates) plus 8 output xors; a leaf of W words costs
// ceil(W / 16) compressions against 4 W bytes read, so hashing is far
// above the memory roofline.  The design keeps everything in registers
// and lets rotates map to funnel shifts.
#include "m31.cuh"

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define NZT_G(a, b, c, d, x, y) \
  a = a + b + (x);              \
  d = rotr(d ^ a, 16);          \
  c = c + d;                    \
  b = rotr(b ^ c, 12);          \
  a = a + b + (y);              \
  d = rotr(d ^ a, 8);           \
  c = c + d;                    \
  b = rotr(b ^ c, 7);

#define NZT_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, \
                  s13, s14, s15)                                          \
  NZT_G(v0, v4, v8, v12, m[s0], m[s1])                                    \
  NZT_G(v1, v5, v9, v13, m[s2], m[s3])                                    \
  NZT_G(v2, v6, v10, v14, m[s4], m[s5])                                   \
  NZT_G(v3, v7, v11, v15, m[s6], m[s7])                                   \
  NZT_G(v0, v5, v10, v15, m[s8], m[s9])                                   \
  NZT_G(v1, v6, v11, v12, m[s10], m[s11])                                 \
  NZT_G(v2, v7, v8, v13, m[s12], m[s13])                                  \
  NZT_G(v3, v4, v9, v14, m[s14], m[s15])

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u,
                   IV3 = 0xA54FF53Au, IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu,
                   IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;
// parameter block word 0 of an unkeyed 32-byte digest
constexpr uint32_t PARAM0 = 0x01010020u;

__device__ __forceinline__ void init_state(uint32_t h[8]) {
  h[0] = IV0 ^ PARAM0; h[1] = IV1; h[2] = IV2; h[3] = IV3;
  h[4] = IV4; h[5] = IV5; h[6] = IV6; h[7] = IV7;
}

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint64_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint32_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = IV0, v9 = IV1, v10 = IV2, v11 = IV3;
  uint32_t v12 = IV4 ^ (uint32_t)t, v13 = IV5 ^ (uint32_t)(t >> 32);
  uint32_t v14 = last ? ~IV6 : IV6, v15 = IV7;
  NZT_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  NZT_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  NZT_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  NZT_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  NZT_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  NZT_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  NZT_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  NZT_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  NZT_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  NZT_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;  h[1] ^= v1 ^ v9;  h[2] ^= v2 ^ v10; h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12; h[5] ^= v5 ^ v13; h[6] ^= v6 ^ v14; h[7] ^= v7 ^ v15;
}

__device__ __forceinline__ void store_digest(uint32_t* out, const uint32_t h[8]) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(h[0], h[1], h[2], h[3]);
  o[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

__global__ void blake2s_messages(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out, long long R,
                                 int W, long long stride_r,
                                 long long stride_w) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint32_t* base = in + r * stride_r;
  uint32_t h[8];
  init_state(h);
  int nblocks = W > 16 ? (W + 15) / 16 : 1;
  for (int blk = 0; blk < nblocks; ++blk) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int w = blk * 16 + i;
      m[i] = w < W ? __ldg(base + (long long)w * stride_w) : 0u;
    }
    bool last = blk == nblocks - 1;
    compress(h, m, last ? 4ull * (uint64_t)W : 64ull * (uint64_t)(blk + 1),
             last);
  }
  store_digest(out + r * 8, h);
}

__global__ void blake2s_parents(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out, long long R) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint4* p = reinterpret_cast<const uint4*>(in + r * 16);
  uint32_t m[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = __ldg(p + q);
    m[4 * q] = v.x; m[4 * q + 1] = v.y; m[4 * q + 2] = v.z; m[4 * q + 3] = v.w;
  }
  uint32_t h[8];
  init_state(h);
  compress(h, m, 64, true);
  store_digest(out + r * 8, h);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int nzt_blake2s_messages(const uint32_t* in, uint32_t* out,
                                    long long R, int W, long long stride_r,
                                    long long stride_w, void* stream) {
  long long blocks = (R + kThreads - 1) / kThreads;
  blake2s_messages<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, R, W, stride_r, stride_w);
  return (int)cudaGetLastError();
}

extern "C" int nzt_blake2s_parents(const uint32_t* in, uint32_t* out,
                                   long long R, void* stream) {
  long long blocks = (R + kThreads - 1) / kThreads;
  blake2s_parents<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, R);
  return (int)cudaGetLastError();
}

// K9: the opening gather of a proof.
//
// Replaces the JAX package's device program nexus_zkvm_tpu/ops/merkle.py
// `decommit_many_fused` (:440, aot_call :482): the column values at the
// queried positions and the sibling-hash rows of every Merkle opening of
// a proof, gathered into one buffer that reaches the host in one copy.
//
// A host table of descriptors, nine int64 words each:
//   (source address, out word offset, index offset, n, W, rows,
//    row stride, index stride, word stride)   (strides in words)
// gathers
//   out[off + (r * n + i) * W + t] = src[r * rs + idx[i] * is + t * ts]
// for r < rows, i < n, t < W: the (C, Q) values of a uniform tree's
// column matrix (rows C, W 1), a mixed tree's column (rows 1, W 1), a
// layer's sibling digests (rows 1, W 8).  Strides let a transposed view
// (FRI's layer matrices) be read in place.
//
// One block per descriptor walks its words with consecutive threads on
// consecutive output words.  What bounds it: the bytes, a few MB a
// proof; in practice the launch, since each descriptor is small.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_openings(const long long* __restrict__ desc, const long long* __restrict__ idx,
                uint32_t* __restrict__ out) {
  const long long* d = desc + 9 * (long long)blockIdx.x;
  const uint32_t* src = (const uint32_t*)__ldg(d);
  const long long off = __ldg(d + 1), ioff = __ldg(d + 2), n = __ldg(d + 3);
  const long long W = __ldg(d + 4), rows = __ldg(d + 5), rs = __ldg(d + 6);
  const long long is = __ldg(d + 7), ts = __ldg(d + 8);
  const long long per_row = n * W, total = rows * per_row;
  for (long long e = threadIdx.x; e < total; e += kThreads) {
    const long long r = e / per_row, rem = e - r * per_row;
    const long long i = rem / W, t = rem - i * W;
    out[off + e] = __ldg(src + r * rs + __ldg(idx + ioff + i) * is + t * ts);
  }
}

}  // namespace

// desc (n_desc, 9) int64 and idx int64 (device copies of the host
// tables); out int32 words.
extern "C" int nzt_gather_openings(const long long* desc, int n_desc,
                                   const long long* idx, uint32_t* out,
                                   void* stream) {
  if (n_desc <= 0) return (int)cudaErrorInvalidValue;
  gather_openings<<<(unsigned)n_desc, kThreads, 0, (cudaStream_t)stream>>>(
      desc, idx, out);
  return (int)cudaGetLastError();
}

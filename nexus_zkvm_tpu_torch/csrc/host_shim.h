// Lets a kernel source written for nvcc compile as plain C++ with a host
// compiler (g++ -DNZT_HOST): the CUDA qualifiers vanish, __ldg is a plain
// read, and the vector types the M31 header uses are plain structs.  The
// generated K7 sources (air_eval_gen.cuh) then run one row after another
// in a loop, so the CPU tests can hold the emitted text to the plain
// interpreter.
#pragma once

#include <cstdint>
#include <cstring>

#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(...)

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

struct uint4 {
  uint32_t x, y, z, w;
};

inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}

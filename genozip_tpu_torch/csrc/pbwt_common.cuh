// The PBWT kernels' shared memory and constants: the part of csrc/pbwt.cu
// that the transform and the row's chain floor (csrc/devfns_micro.cu)
// share. See pbwt.cu for the design.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pbwtk {

constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 256;
constexpr int SMEM_H = 4096;   // perm in shared memory up to this H
constexpr int META = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 256;      // the value of a thread past the row's end

struct Smem {
  int perm[2][SMEM_H];           // perm and its sorted copy
  uint16_t wcnt[2][32][256];     // (warp, value) counts, double buffered
  int run[256];                  // each value's next position in the row
  int hist[256];                 // each value's count in the row
  int cbase[2][256];             // run at the chunk's start
  int wtot[8];                   // scan of the histogram: 8 warps' sums
};

__device__ __forceinline__ uint32_t lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1;
}

}  // namespace pbwtk

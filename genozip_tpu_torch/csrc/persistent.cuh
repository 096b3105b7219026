// The size of a persistent grid, shared by the AES (aes.cu) and seed
// aligner (seed_align.cu) kernels: as many blocks as are resident on the
// current device at once, asked of the occupancy API once a device and
// launch shape and kept.
#pragma once

#include <cuda_runtime.h>

namespace persistent {

constexpr int MAX_DEVICES = 64;

// blocks of `kernel` resident on the current device at `threads` threads
// and `smem` dynamic shared bytes a block; `cache` holds one count a device
// for each launch shape `key` < N (0: not asked yet). Falls back to 132
// (one a SM of an H100) when the API gives nothing.
template <int N, typename Kernel>
int resident_blocks(int (&cache)[MAX_DEVICES][N], int key, Kernel kernel,
                    int threads, size_t smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    dev = 0;
  int& got = cache[dev][key];
  if (got == 0) {
    int sms = 0, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                  smem);
    got = sms * per > 0 ? sms * per : 132;
  }
  return got;
}

}  // namespace persistent

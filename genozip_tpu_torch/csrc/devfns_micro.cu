// Chain floors of the ARITH-W32 coder (csrc/arith.cu) and the PBWT
// (csrc/pbwt.cu): kernels that take the serial chain of a coder's steps or
// a transform's rows (the same barriers, ranks and scans) with no symbol
// or value loaded or stored. Only chip_smoke.py builds and runs them, to
// set beside the coders' times what the chain alone costs; no entry point
// of the package calls them.

#include <cstdint>
#include <cuda_runtime.h>

#include "arith_model.cuh"
#include "pbwt_common.cuh"

namespace arith_floor {

using namespace arithk;

// the chain floor of a step: the barriers, ranks and model scan of `steps`
// steps in which `iters` renorm iterations move every lane and no symbol is
// coded or read
template <int ORDER>
__global__ void __launch_bounds__(MAX_THREADS)
arith_floor_kernel(int64_t steps, int iters, int N, int64_t* sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<ORDER>& sm = *reinterpret_cast<Smem<ORDER>*>(smem_raw);
  const int t = threadIdx.x;
  model_init(sm);
  int64_t ev = 0;
  uint32_t x = 0;
  int parity = 0;
  for (int64_t s = 0; s < steps; s++) {
    for (int it = 0;; it++) {
      const bool go = t < N && it < iters;
      int* ws = sm.wrank[parity];
      parity ^= 1;
      const unsigned b = __ballot_sync(FULL, go);
      if ((t & 31) == 0) ws[t >> 5] = __popc(b);
      if (!__syncthreads_or(go)) break;
      int cnt;
      x += warps_prefix(ws, &cnt) + __popc(b & lanemask_lt());
      ev += cnt;
    }
    model_update(sm, false, 0u, 0u);
  }
  if (t == 0) sink[blockIdx.x] = ev + x;
}

}  // namespace arith_floor

namespace pbwt_floor {

using namespace pbwtk;

// the chain floor of a row: the barriers, warp matches and column scans of
// `rows` rows of H values, with no value loaded or stored
__global__ void __launch_bounds__(MAX_THREADS)
pbwt_floor_kernel(int64_t rows, int H, int64_t* sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, w = t >> 5, T = blockDim.x, nw = T >> 5;
  for (int i = t; i < 2 * 32 * 256; i += T) (&sm.wcnt[0][0][0])[i] = 0;
  __syncthreads();
  int par = 0, x = 0;
  for (int64_t i = 0; i < rows; i++) {
    __syncthreads();
    __syncthreads();
    __syncthreads();
    for (int base = 0; base < H; base += T, par ^= 1) {
      const int v = base + t < H ? (int)((i + t) & 3) : NONE;
      const unsigned peers = __match_any_sync(FULL, v);
      x += __popc(peers & lanemask_lt());
      __syncthreads();
      if (t < 256) {
        int acc = 0;
        for (int k = 0; k < nw; k++) acc += sm.wcnt[par][k][t];
        x += acc;
      }
      __syncthreads();
    }
  }
  if (t == 0) sink[blockIdx.x] = x + w;
}

}  // namespace pbwt_floor

extern "C" {

// arith_floor_kernel on R blocks of `threads` threads, N lanes
int arith_step_floor(int order, long long steps, int iters, int N,
                     int threads, int R, void* sink, void* stream) {
  using arith_floor::arith_floor_kernel;
  const size_t smem =
      order ? sizeof(arithk::Smem<1>) : sizeof(arithk::Smem<0>);
  const cudaStream_t st = (cudaStream_t)stream;
  if (order) {
    const cudaError_t e = cudaFuncSetAttribute(
        arith_floor_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    arith_floor_kernel<1><<<R, threads, smem, st>>>(steps, iters, N,
                                                    (int64_t*)sink);
  } else {
    arith_floor_kernel<0><<<R, threads, smem, st>>>(steps, iters, N,
                                                    (int64_t*)sink);
  }
  return (int)cudaGetLastError();
}

// pbwt_floor_kernel on R blocks of `threads` threads
int pbwt_row_floor(long long rows, int H, int threads, int R, void* sink,
                   void* stream) {
  using pbwt_floor::pbwt_floor_kernel;
  const size_t smem = sizeof(pbwtk::Smem);
  const cudaError_t e = cudaFuncSetAttribute(
      pbwt_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  pbwt_floor_kernel<<<R, threads, smem, (cudaStream_t)stream>>>(
      rows, H, (int64_t*)sink);
  return (int)cudaGetLastError();
}

}  // extern "C"

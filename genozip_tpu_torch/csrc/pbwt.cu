// Positional Burrows-Wheeler transform of haplotype matrices: two
// hand-written Hopper kernels (sm_90a), pbwt_encode and pbwt_decode (one
// template).
//
// The function is genozip_tpu's PBWT of the VCF genotype matrix
// (genozip_tpu/ops/pbwt.py `pbwt_encode_jnp` :46 and `pbwt_decode_jnp` :61,
// XLA device functions under lax.scan; no Pallas kernel): for each variant
// row i of the (n, H) uint8 matrix, in order, the row is emitted in the
// current permutation order, y[j] = A[i, perm[j]] (decode: A[i, perm[j]] =
// Y[i, j]), and then perm is stably sorted by y. The plain version is
// ops/pbwt_torch.py; the two are equal, and equal to pbwt_encode_np.
//
// What bounds it: not bytes (2 n H) nor operations (a few tens a value),
// but the chain of n rows, each a stable sort that the next row's gather
// waits on: a row is a few block-wide barriers a chunk of H / threads
// values. chip_smoke.py measures that chain's floor (`pbwt_row_floor`,
// csrc/devfns_micro.cu).
//
// Design: one block a matrix (R matrices a launch, through a table of int64
// rows (offset of the matrix, n, H, offset of its perm scratch)), rows
// serial, T threads (T >= 256, a multiple of 32, at most 1024), the row
// taken in chunks of T values, value j by thread j mod T in both passes.
// Pass A gathers (or scatters) the row and counts each value's
// occurrences: __match_any_sync groups the warp's equal values and the
// group's lowest lane adds its size to a shared histogram. A scan of the
// 256 counts gives each value's first position. Pass B is the stable
// counting sort, chunk by chunk: a value's rank in its warp is the __popc
// of its lower peers, each group's lowest lane stores the group's size in a
// (warp, value) table, and thread v < 256 scans value v's column over the
// warps, adding the value's running base; each value lands at base +
// column prefix + rank. The table is double buffered (thread v clears its
// column of the other buffer while scanning), so a chunk takes two
// barriers. Values are any byte, 0..255 (the VCF's GT uses 0..10).
// perm (and the sorted copy beside it) lives in shared memory while H <=
// SMEM_H, in the launch's global scratch beyond that.

#include <cstdint>
#include <cuda_runtime.h>

#include "pbwt_common.cuh"

namespace {

using namespace pbwtk;

template <bool DECODE>
__global__ void __launch_bounds__(MAX_THREADS)
pbwt_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            const int64_t* __restrict__ meta, int32_t* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t off = m[0], n = m[1];
  const int H = (int)m[2];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, T = blockDim.x;
  const int nw = T >> 5;
  if (n == 0 || H == 0) return;          // the same in every thread
  int* src = H <= SMEM_H ? sm.perm[0] : work + m[3];
  int* dst = H <= SMEM_H ? sm.perm[1] : work + m[3] + H;
  for (int j = t; j < H; j += T) src[j] = j;
  for (int i = t; i < 2 * 32 * 256; i += T) (&sm.wcnt[0][0][0])[i] = 0;
  if (t < 256) sm.hist[t] = 0;
  __syncthreads();
  int par = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* a = in + off + i * H;
    uint8_t* y = out + off + i * H;
    // pass A: the row in perm order, and each value's count
    for (int base = 0; base < H; base += T) {
      const int j = base + t;
      int v = NONE;
      if (j < H) {
        const int p = src[j];
        if (DECODE) {
          v = a[j];
          y[p] = (uint8_t)v;
        } else {
          v = a[p];
          y[j] = (uint8_t)v;
        }
      }
      const unsigned peers = __match_any_sync(FULL, v);
      if (v != NONE && (peers & lanemask_lt()) == 0)
        atomicAdd(&sm.hist[v], __popc(peers));
    }
    __syncthreads();
    // each value's first position: an exclusive scan of the counts
    int h = 0, incl = 0;
    if (t < 256) {
      h = sm.hist[t];
      incl = h;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += x;
      }
      if (lane == 31) sm.wtot[w] = incl;
    }
    __syncthreads();
    if (t < 256) {
      int before = 0;
      for (int k = 0; k < w; k++) before += sm.wtot[k];
      sm.run[t] = before + incl - h;
      sm.hist[t] = 0;
    }
    __syncthreads();
    // pass B: the stable counting sort of perm by the row's values
    for (int base = 0; base < H; base += T, par ^= 1) {
      const int j = base + t;
      int v = NONE, p = 0;
      if (j < H) {
        v = DECODE ? a[j] : y[j];
        p = src[j];
      }
      const unsigned peers = __match_any_sync(FULL, v);
      const int rank = __popc(peers & lanemask_lt());
      uint16_t(*wc)[256] = sm.wcnt[par];
      if (v != NONE && rank == 0) wc[w][v] = (uint16_t)__popc(peers);
      __syncthreads();
      if (t < 256) {
        int acc = 0;
        for (int k = 0; k < nw; k++) {
          const int x = wc[k][t];
          wc[k][t] = (uint16_t)acc;
          acc += x;
          sm.wcnt[par ^ 1][k][t] = 0;
        }
        sm.cbase[par][t] = sm.run[t];
        sm.run[t] += acc;
      }
      __syncthreads();
      if (v != NONE) dst[sm.cbase[par][v] + wc[w][v] + rank] = p;
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
}

template <bool DECODE>
int launch(const void* in, void* out, const void* meta, int R, int threads,
           void* work, void* stream) {
  if (R <= 0) return 0;
  if (threads < MIN_THREADS || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      pbwt_kernel<DECODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  pbwt_kernel<DECODE><<<R, threads, sizeof(Smem), (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int64_t*)meta,
      (int32_t*)work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// R matrices: in and out hold them (n x H bytes each, row-major, at the
// same offsets); meta R rows of (offset, n, H, offset in int32 words of
// the matrix's 2 H words of work, used when H > 4096). threads: a multiple
// of 32 in [256, 1024]. Returns the CUDA error of the launch.
int pbwt_encode(const void* in, void* out, const void* meta, int R,
                int threads, void* work, void* stream) {
  return launch<false>(in, out, meta, R, threads, work, stream);
}

int pbwt_decode(const void* in, void* out, const void* meta, int R,
                int threads, void* work, void* stream) {
  return launch<true>(in, out, meta, R, threads, work, stream);
}

}  // extern "C"

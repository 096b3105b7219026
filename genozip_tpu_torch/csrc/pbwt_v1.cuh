// PR 12's PBWT kernels, frozen: one block a matrix, the row in chunks of T
// values, pass A (gather and a shared histogram), a block scan of the 256
// counts, pass B (per-warp ranks, a (warp, value) table and a column scan
// of all 256 values a chunk), perm in shared memory up to 4,096 values and
// in the launch's scratch beyond. Only csrc/devfns_micro.cu includes it,
// for the version-1 row floor and the probes that take one piece of that
// row out at a time (scripts/pbwt_probe.py); the shipped kernels are
// csrc/pbwt.cu on csrc/pbwt_common.cuh.
//
// VAR bits (0: PR 12's kernel as it was, byte for byte):
//   NO_GLOBAL: the row's bytes come from shared memory (a ring of the
//     matrix's first RING rows, loaded before the first row; row i reads
//     slot i mod RING), and pass B reads them there; y is still stored.
//   PRESENT_ONLY: pass B's column scan runs over the row's present values
//     only (a list built in the histogram scan); a warp zeroes its own
//     table entries after its scatter, so no column is cleared.
//   FEWER_BARRIERS: no barriers of their own for the histogram scan: each
//     of the first 8 warps scans all 256 counts itself after pass A's
//     barrier (the histogram double buffered over rows), so a row takes
//     pass A's barrier, two a chunk and the end one.
//   PERM_SMEM: perm in shared memory up to PERM_SMEM_H values (int32).
// A probe's output is PR 12's only for VAR 0 and for FEWER_BARRIERS,
// PRESENT_ONLY and PERM_SMEM (which change no value); NO_GLOBAL's is not.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pbwt_v1 {

constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 256;
constexpr int SMEM_H = 4096;        // perm in shared memory up to this H
constexpr int PERM_SMEM_H = 8192;   // ... and with PERM_SMEM
constexpr int RING = 4;             // NO_GLOBAL's rows
constexpr int META = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = 256;

enum { NO_GLOBAL = 1, PRESENT_ONLY = 2, FEWER_BARRIERS = 4, PERM_SMEM = 8 };

// PR 12's shared memory, and the version-1 floor's
struct Smem {
  int perm[2][SMEM_H];
  uint16_t wcnt[2][32][256];
  int run[256];
  int hist[256];
  int cbase[2][256];
  int wtot[8];
};

// the probes' shared memory: PR 12's and what the VAR bits add
struct ProbeSmem {
  int perm[2][PERM_SMEM_H];
  uint16_t wcnt[2][32][256];
  int run[256];
  int hist[2][256];
  int cbase[2][256];
  int wtot[8];
  int wpres[8];
  int plist[256];
  uint8_t ring[RING][PERM_SMEM_H];
  uint8_t yrow[PERM_SMEM_H];
};

__device__ __forceinline__ uint32_t lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1;
}

template <bool DECODE, int VAR>
__global__ void __launch_bounds__(MAX_THREADS)
probe_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             const int64_t* __restrict__ meta, int32_t* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ProbeSmem& sm = *reinterpret_cast<ProbeSmem*>(smem_raw);
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t off = m[0], n = m[1];
  const int H = (int)m[2];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, T = blockDim.x;
  const int nw = T >> 5;
  constexpr int PH = (VAR & PERM_SMEM) ? PERM_SMEM_H : SMEM_H;
  if (n == 0 || H == 0) return;
  if ((VAR & NO_GLOBAL) && H > PERM_SMEM_H) return;   // no room: nothing
  int* src = H <= PH ? sm.perm[0] : work + m[3];
  int* dst = H <= PH ? sm.perm[1] : work + m[3] + H;
  for (int j = t; j < H; j += T) src[j] = j;
  for (int i = t; i < 2 * 32 * 256; i += T) (&sm.wcnt[0][0][0])[i] = 0;
  if (t < 256) sm.hist[0][t] = sm.hist[1][t] = 0;
  if (VAR & NO_GLOBAL)
    for (int r = 0; r < RING && r < n; r++)
      for (int j = t; j < H; j += T) sm.ring[r][j] = in[off + r * H + j];
  __syncthreads();
  int par = 0, hp = 0;
  for (int64_t i = 0; i < n; i++, hp ^= 1) {
    const uint8_t* a = (VAR & NO_GLOBAL) ? sm.ring[i % RING] : in + off + i * H;
    uint8_t* y = out + off + i * H;
    int* hist = sm.hist[(VAR & FEWER_BARRIERS) ? hp : 0];
    if ((VAR & FEWER_BARRIERS) && t < 256) sm.hist[hp ^ 1][t] = 0;
    // pass A
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
          if (VAR & NO_GLOBAL) sm.yrow[j] = (uint8_t)v;
        }
      }
      const unsigned peers = __match_any_sync(FULL, v);
      if (v != NONE && (peers & lanemask_lt()) == 0)
        atomicAdd(&hist[v], __popc(peers));
    }
    __syncthreads();
    int npres = 256;
    if (VAR & FEWER_BARRIERS) {
      if (t < 256) {
        const int h = hist[t];
        int incl = h;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += x;
        }
        int lower = 0;
        for (int k = 0; k < w; k++) lower += hist[32 * k + lane];
        sm.run[t] = __reduce_add_sync(FULL, lower) + incl - h;
      }
    } else {
      int h = 0, incl = 0;
      unsigned pb = 0;
      if (t < 256) {
        h = hist[t];
        incl = h;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += x;
        }
        if (VAR & PRESENT_ONLY) pb = __ballot_sync(FULL, h > 0);
        if (lane == 31) {
          sm.wtot[w] = incl;
          if (VAR & PRESENT_ONLY) sm.wpres[w] = __popc(pb);
        }
      }
      __syncthreads();
      if (t < 256) {
        int before = 0, pbefore = 0;
        for (int k = 0; k < w; k++) {
          before += sm.wtot[k];
          if (VAR & PRESENT_ONLY) pbefore += sm.wpres[k];
        }
        sm.run[t] = before + incl - h;
        hist[t] = 0;
        if ((VAR & PRESENT_ONLY) && h > 0)
          sm.plist[pbefore + __popc(pb & lanemask_lt())] = t;
      }
      __syncthreads();
      if (VAR & PRESENT_ONLY) {
        npres = 0;
        for (int k = 0; k < 8; k++) npres += sm.wpres[k];
      }
    }
    // pass B
    for (int base = 0; base < H; base += T, par ^= 1) {
      const int j = base + t;
      int v = NONE, p = 0;
      if (j < H) {
        v = DECODE ? a[j] : ((VAR & NO_GLOBAL) ? sm.yrow[j] : y[j]);
        p = src[j];
      }
      const unsigned peers = __match_any_sync(FULL, v);
      const int rank = __popc(peers & lanemask_lt());
      uint16_t(*wc)[256] = sm.wcnt[par];
      if (v != NONE && rank == 0) wc[w][v] = (uint16_t)__popc(peers);
      __syncthreads();
      const int col = (VAR & PRESENT_ONLY) ? (t < npres ? sm.plist[t] : -1)
                                           : (t < 256 ? t : -1);
      if (col >= 0) {
        int acc = 0;
        for (int k = 0; k < nw; k++) {
          const int x = wc[k][col];
          if (VAR & PRESENT_ONLY) {
            if (x) wc[k][col] = (uint16_t)acc;
          } else {
            wc[k][col] = (uint16_t)acc;
            sm.wcnt[par ^ 1][k][col] = 0;
          }
          acc += x;
        }
        sm.cbase[par][col] = sm.run[col];
        sm.run[col] += acc;
      }
      __syncthreads();
      if (v != NONE) dst[sm.cbase[par][v] + wc[w][v] + rank] = p;
      if (VAR & PRESENT_ONLY) {
        __syncwarp();
        if (v != NONE && rank == 0) wc[w][v] = 0;
      }
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
}

template <bool DECODE, int VAR>
int launch(const void* in, void* out, const void* meta, int R, int threads,
           void* work, void* stream) {
  if (R <= 0) return 0;
  if (threads < MIN_THREADS || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      probe_kernel<DECODE, VAR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(ProbeSmem));
  if (e != cudaSuccess) return (int)e;
  probe_kernel<DECODE, VAR><<<R, threads, sizeof(ProbeSmem),
                              (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int64_t*)meta,
      (int32_t*)work);
  return (int)cudaGetLastError();
}

template <bool DECODE>
int run_var(int var, const void* in, void* out, const void* meta, int R,
            int threads, void* work, void* stream) {
  switch (var) {
    case 0: return launch<DECODE, 0>(in, out, meta, R, threads, work, stream);
    case NO_GLOBAL:
      return launch<DECODE, NO_GLOBAL>(in, out, meta, R, threads, work,
                                       stream);
    case PRESENT_ONLY:
      return launch<DECODE, PRESENT_ONLY>(in, out, meta, R, threads, work,
                                          stream);
    case FEWER_BARRIERS:
      return launch<DECODE, FEWER_BARRIERS>(in, out, meta, R, threads, work,
                                            stream);
    case PERM_SMEM:
      return launch<DECODE, PERM_SMEM>(in, out, meta, R, threads, work,
                                       stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pbwt_v1

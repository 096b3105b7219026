// The ARITH-W32 coder's shared adaptive model in shared memory, and the
// block-wide ranks its steps take: the part of csrc/arith.cu that the
// coders and the step's chain floor (csrc/devfns_micro.cu) share. See
// arith.cu for the layout and the design.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace arithk {

constexpr uint32_t TOP = 1u << 24, BOT = 1u << 16;
constexpr uint32_t INC = 24, MAX_TOTAL = 1u << 15;
constexpr int MAX_THREADS = 1024;     // one a lane: N <= 1024
constexpr int MIN_THREADS = 256;      // one a symbol of the model
constexpr int HEADER = 6;
constexpr int META = 6;
constexpr unsigned FULL = 0xffffffffu;

template <int ORDER>
struct Smem {
  static constexpr int NWORDS = ORDER ? 256 * 128 : 128;
  uint32_t words[NWORDS];        // packed u16 frequencies
  uint32_t aux[ORDER ? 256 : 257];  // o1: totals; o0: exclusive cum + total
  int wrank[2][32];              // renorm: warps' counts, double buffered
  int wscan[32];                 // block_rank's warps' counts
  int list[256];                 // contexts to halve
  uint32_t wtot[8];              // order 0 scan: the 8 warps' sums
};

__device__ __forceinline__ uint32_t half_of(uint32_t word, uint32_t sym) {
  return (sym & 1) ? word >> 16 : word & 0xffffu;
}

__device__ __forceinline__ uint32_t halve(uint32_t x) {
  return (((x & 0xffffu) + 1) >> 1) | ((((x >> 16) + 1) >> 1) << 16);
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1;
}

// exclusive prefix over the warps of the counts in ws[0 .. nw-1], for this
// thread's warp; *count gets the sum over all warps (no barrier inside)
__device__ __forceinline__ int warps_prefix(const int* ws, int* count) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int x = lane < nw ? ws[lane] : 0;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  *count = __shfl_sync(FULL, incl, 31);
  return __shfl_sync(FULL, incl - x, threadIdx.x >> 5);
}

// block-wide exclusive rank of `pred` (one barrier inside)
__device__ __forceinline__ int block_rank(bool pred, int* ws, int* count) {
  const unsigned b = __ballot_sync(FULL, pred);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = __popc(b);
  __syncthreads();
  return warps_prefix(ws, count) + __popc(b & lanemask_lt());
}

// word w (0..127) of context c's row; order 1 rows are swizzled by slot
template <int ORDER>
__device__ __forceinline__ int word_index(uint32_t c, uint32_t w) {
  if (!ORDER) return (int)w;
  return (int)(c * 128 + ((((w >> 2) ^ (c & 7)) << 2) | (w & 3)));
}

// order 0: rebuild the exclusive cumulative row and total from the words,
// halving while the total exceeds MAX_TOTAL; ends on a barrier
template <int ORDER>
__device__ void o0_rebuild(Smem<ORDER>& sm) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (;;) {
    uint32_t f = 0, incl = 0;
    if (t < 256) {
      f = half_of(sm.words[t >> 1], t);
      incl = f;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) sm.wtot[w] = incl;
    }
    __syncthreads();
    uint32_t total = 0, before = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const uint32_t x = sm.wtot[i];
      total += x;
      if (i < w) before += x;
    }
    if (t < 256) sm.aux[t] = before + incl - f;
    if (total <= MAX_TOTAL) {
      if (t == 0) sm.aux[256] = total;
      break;
    }
    __syncthreads();
    if (t < 128) sm.words[t] = halve(sm.words[t]);
    __syncthreads();
  }
  __syncthreads();
}

// order 1: halve every context over MAX_TOTAL until none is; called after
// the update's barrier, ends on a barrier
template <int ORDER>
__device__ void o1_rescale(Smem<ORDER>& sm) {
  const int t = threadIdx.x, lane = t & 31, nw = blockDim.x >> 5;
  bool over = t < 256 && sm.aux[t] > MAX_TOTAL;
  while (__syncthreads_or(over)) {
    int cnt;
    const int rk = block_rank(over, sm.wscan, &cnt);
    if (over) sm.list[rk] = t;
    __syncthreads();
    for (int i = t >> 5; i < cnt; i += nw) {
      uint32_t* row = sm.words + sm.list[i] * 128;
      uint32_t s = 0;
#pragma unroll
      for (int k = 0; k < 4; k++) {
        const uint32_t x = halve(row[4 * lane + k]);
        row[4 * lane + k] = x;
        s += x;
      }
      uint32_t sum = (s & 0xffffu) + (s >> 16);
#pragma unroll
      for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
      if (lane == 0) sm.aux[sm.list[i]] = sum;
    }
    __syncthreads();
    over = t < 256 && sm.aux[t] > MAX_TOTAL;
  }
}

template <int ORDER>
__device__ void model_init(Smem<ORDER>& sm) {
  for (int i = threadIdx.x; i < Smem<ORDER>::NWORDS; i += blockDim.x)
    sm.words[i] = 0x00010001u;
  if (ORDER)
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sm.aux[i] = 256;
  __syncthreads();
  if (!ORDER) o0_rebuild(sm);
}

// after a step: +INC for each active lane's (context, symbol), then halve;
// ends on a barrier
template <int ORDER>
__device__ __forceinline__ void model_update(Smem<ORDER>& sm, bool act,
                                             uint32_t ctx, uint32_t sym) {
  if (act) {
    atomicAdd(&sm.words[word_index<ORDER>(ctx, sym >> 1)],
              INC << (16 * (sym & 1)));
    if (ORDER) atomicAdd(&sm.aux[ctx], INC);
  }
  __syncthreads();
  if (ORDER) o1_rescale(sm);
  else o0_rebuild(sm);
}

}  // namespace arithk

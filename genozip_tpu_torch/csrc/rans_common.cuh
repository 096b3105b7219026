// Constants, the per-step word ranking, the decoders' packed slot entries
// and their renorm-word ring, shared by the rANS kernels (rans.cu) and their
// microbenchmarks (rans_micro.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rans {

constexpr int NT = 1024;          // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int JMAX = 8;           // lanes per thread: N <= 8192
constexpr uint32_t RANS_L = 1u << 16;
constexpr int SCALE_BITS = 12;
constexpr uint32_t SLOT_MASK = (1u << SCALE_BITS) - 1;
constexpr int META = 8;           // int64 words per stream in `meta`

struct NoHook {
  __device__ void operator()() const {}
};

// Ranks this step's flagged lanes in lane-ascending order across the block.
// flags bit j covers lane j*NT + threadIdx.x. On return rank[j] is the
// flagged lane's position among all flagged lanes of the step, and the return
// value is the step's total. `cnt` (2 * JMAX * NW) and `tot` (2) are shared
// buffers, used alternately by parity so each step needs two barriers only.
// `between` runs on every thread between the two barriers, while warp 0's
// scan is the only other work in flight.
template <typename Hook = NoHook>
__device__ __forceinline__ uint32_t block_rank(uint32_t flags, int J, int par,
                                               uint32_t* cnt, uint32_t* tot,
                                               uint32_t (&rank)[JMAX],
                                               Hook&& between = Hook()) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t* c = cnt + par * (JMAX * NW);
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    if (j < J) {                  // J is uniform across the block
      const uint32_t b = __ballot_sync(0xffffffffu, (flags >> j) & 1u);
      rank[j] = __popc(b & below);
      if (lane == 0) c[j * NW + warp] = __popc(b);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan over the J*NW warp totals (j-major = lane order);
    // each of the 32 threads takes 8 consecutive totals
    const int M = J * NW;
    uint32_t v[8], s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = lane * 8 + k;
      v[k] = i < M ? c[i] : 0u;
      s += v[k];
    }
    uint32_t inc = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    uint32_t run = inc - s;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = lane * 8 + k;
      if (i < M) c[i] = run;
      run += v[k];
    }
    if (lane == 31) tot[par] = inc;
  }
  between();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < JMAX; ++j)
    if (j < J) rank[j] += c[j * NW + warp];
  return tot[par];
}

// Ranks this step's flagged lanes when each thread owns J consecutive lanes
// (lane tid*J + j, flags bit j): a thread counts its flags, a warp scans the
// counts with shuffles, and warp 0 scans the 32 warp totals. Returns the
// step's total and in `first` the rank of the thread's first lane, so that
// lane j's rank is first + popc(flags & ((1 << j) - 1)). `cnt` (2 * NW) and
// `tot` (2) are shared buffers used alternately by parity; `between` runs
// on every thread between the two barriers.
template <typename Hook = NoHook>
__device__ __forceinline__ uint32_t block_rank_runs(uint32_t flags, int par,
                                                    uint32_t* cnt,
                                                    uint32_t* tot,
                                                    uint32_t& first,
                                                    Hook&& between = Hook()) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t c = __popc(flags);
  uint32_t inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  uint32_t* cw = cnt + par * NW;
  if (lane == 31) cw[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t v = cw[lane];
    uint32_t s = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    cw[lane] = s - v;
    if (lane == 31) tot[par] = s;
  }
  between();
  __syncthreads();
  first = cw[warp] + inc - c;
  return tot[par];
}

// Packed slot entry of one (freq, cum) row that sums to 4096: the symbol s
// with cum[s] <= slot < cum[s] + freq[s], f - 1 and slot - cum[s], so that
// x' = f * (x >> 12) + (slot - cum[s]) takes one lookup.
__device__ __forceinline__ uint32_t slot_entry(const uint32_t* f,
                                               const uint32_t* c, int slot) {
  int s = 0;                      // c[0] = 0 <= slot
#pragma unroll
  for (int step = 128; step; step >>= 1)
    if (c[s + step] <= (uint32_t)slot) s += step;
  return (uint32_t)s | (((f[s] - 1u) & 0xfffu) << 8) |
         (((uint32_t)slot - c[s]) << 20);
}

// Order-1 slot entries, one block per (context, stream): slots[r][ctx][slot]
// (4 MB a stream), 0 for contexts whose row does not sum to 4096 (not in
// the stream). tab: per stream freq then cum, 256x256 [ctx][sym] int32 each.
__global__ void __launch_bounds__(256)
o1_slots_kernel(const int32_t* __restrict__ tab, uint32_t* __restrict__ slots) {
  __shared__ uint32_t f[256], c[256];
  const int ctx = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int32_t* f2 = tab + (int64_t)r * 2 * 65536 + ctx * 256;
  f[tid] = (uint32_t)f2[tid];
  c[tid] = (uint32_t)f2[65536 + tid];
  __syncthreads();
  const bool used = c[255] + f[255] == (1u << SCALE_BITS);
  uint32_t* dst = slots + (((int64_t)r * 256 + ctx) << SCALE_BITS);
  for (int slot = tid; slot < (1 << SCALE_BITS); slot += 256)
    dst[slot] = used ? slot_entry(f, c, slot) : 0u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A decoder's renorm words, staged in a ring of 4N u16 words (8N bytes) of
// shared memory ahead of the consumer. Word q of the stream sits at byte
// (A(q) mod 8N) of the ring, A(q) its device address, so whole aligned
// 16-byte chunks are copied with cp.async. refill(p, k, K), called at every
// step with the step's first word p by the K threads k = 0..K-1 that do the
// copying (the same ones each step), issues the chunks up to word p + 3N
// (one commit group a step); after cp_async_wait<2>() in those threads and a
// barrier, the words up to p + N are in place. A chunk issued at step s lands
// on words below p_s, which every thread consumed before step s's first
// barrier; step s reads words below p_s + N, issued by step s-2 at the latest.
struct WordRing {
  static constexpr int BYTES = 4 * NT * JMAX * 2;   // 4N words at N = 8192
  uint8_t* ring;
  uintptr_t gbase, gend;          // the stream body's device addresses
  uint32_t rmask;
  int64_t ahead, nwords, ci;      // ci: next chunk to issue

  __device__ __forceinline__ void init(uint8_t* smem, const uint16_t* w,
                                       int64_t nw, int64_t N) {
    ring = smem;
    gbase = (uintptr_t)w;
    gend = gbase + 2 * (uintptr_t)nw;
    rmask = (uint32_t)(8 * N) - 1u;
    ahead = 3 * N;
    nwords = nw;
    ci = (int64_t)((gbase + 4 * (uintptr_t)N) >> 4);   // after 2N states
  }

  __device__ __forceinline__ void refill(int64_t p, int k, int nk) {
    const int64_t wend = p + ahead < nwords ? p + ahead : nwords;
    const int64_t ce = (int64_t)((gbase + 2 * (uintptr_t)wend - 1) >> 4) + 1;
    for (int64_t c = ci + k; c < ce; c += nk) {
      const uintptr_t a = (uintptr_t)c << 4;
      uint8_t* dst = ring + ((uint32_t)a & rmask);
      if (a + 16 <= gend) {
        cp_async16(dst, (const void*)a);
      } else {                    // the stream's last, partial chunk
        for (uintptr_t b = a; b < gend; b += 2)
          *(uint16_t*)(ring + ((uint32_t)b & rmask)) = *(const uint16_t*)b;
      }
    }
    if (ce > ci) ci = ce;
  }

  // word q of the stream, 0 past its end
  __device__ __forceinline__ uint32_t word(int64_t q) const {
    return q < nwords
        ? *(const uint16_t*)(ring + ((uint32_t)(gbase + 2 * (uintptr_t)q) & rmask))
        : 0u;
  }
};

}  // namespace rans

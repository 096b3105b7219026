// The ARITH-W32 coder's shared adaptive model in shared memory and the
// pieces of a step that the coders (csrc/arith.cu) and the step's chain
// floor (csrc/devfns_micro.cu) share: the two-level lookup and search, the
// lane's renormalisation, the block's event slots and the update with its
// halving. See arith.cu for the layout, the proofs and the design; the
// plain mirrors of these pieces are in ops/arith_torch.py.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace arithk {

constexpr uint32_t TOP = 1u << 24, BOT = 1u << 16;
constexpr uint32_t INC = 24, MAX_TOTAL = 1u << 15;
constexpr int MAX_THREADS = 1024;     // one a lane: N <= 1024
constexpr int MIN_THREADS = 32;       // one warp
constexpr int MAX_EVENTS = 3;         // renorm events a lane a step (arith.cu)
constexpr int HEADER = 6;
constexpr int META = 6;
constexpr unsigned FULL = 0xffffffffu;
// a frequency, a group sum and a total stay u16 while a step adds N * INC
// to a total of at most MAX_TOTAL, and one halving, (f + 1) >> 1 of 256
// frequencies, brings it back under MAX_TOTAL
static_assert(MAX_TOTAL + MAX_THREADS * INC < (1u << 16), "u16 halves");
static_assert(MAX_THREADS * INC + 256 <= MAX_TOTAL, "one halving a step");

template <int ORDER>
struct Smem {
  static constexpr int NCTX = ORDER ? 256 : 1;
  uint32_t words[NCTX * 128];   // packed u16 frequencies, slot-swizzled
  uint32_t gsum[NCTX * 8];      // packed u16 sums of 16 symbols, swizzled
  uint32_t total[NCTX];
  uint2 cnt[32];                // warp w's renorm counts: (e0 | e1 << 16, e2)
  int list[NCTX];               // contexts to halve
  int nlist;
};

__device__ __forceinline__ uint32_t halve(uint32_t x) {
  return (((x & 0xffffu) + 1) >> 1) | ((((x >> 16) + 1) >> 1) << 16);
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1;
}

// frequency word w (0..127) of context c: 16-byte slot w >> 2 of the row
// at slot (w >> 2) ^ (c & 7)
template <int ORDER>
__device__ __forceinline__ int word_index(uint32_t c, uint32_t w) {
  if (!ORDER) return (int)w;
  return (int)(c * 128 + ((((w >> 2) ^ (c & 7)) << 2) | (w & 3)));
}

// group-sum word k (0..7, groups 2k and 2k + 1) of context c: slot k >> 2
// of the context's two at slot (k >> 2) ^ ((c >> 2) & 1)
__device__ __forceinline__ int gsum_index(uint32_t c, uint32_t k) {
  return (int)(c * 8 + ((((k >> 2) ^ ((c >> 2) & 1)) << 2) | (k & 3)));
}

__device__ __forceinline__ void unpack(const uint4& a, const uint4& b,
                                       uint32_t (&w)[8]) {
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// the 16 u16 halves of a context's group sums, or of one group's
// frequencies: two 16-byte loads each
template <int ORDER>
__device__ __forceinline__ void load_gsums(const Smem<ORDER>& sm, uint32_t c,
                                           uint32_t (&w)[8]) {
  const uint4* g = reinterpret_cast<const uint4*>(sm.gsum) + 2 * c;
  const uint32_t sw = (c >> 2) & 1;
  unpack(g[sw], g[sw ^ 1], w);
}

template <int ORDER>
__device__ __forceinline__ void load_group(const Smem<ORDER>& sm, uint32_t c,
                                           uint32_t grp, uint32_t (&w)[8]) {
  const uint4* row = reinterpret_cast<const uint4*>(sm.words + c * 128);
  const uint32_t sw = ORDER ? c & 7 : 0;
  unpack(row[(2 * grp) ^ sw], row[(2 * grp + 1) ^ sw], w);
}

// the sum of the first k (0..16) halves of 8 packed words: every partial
// sum is at most a context's total (< 2^16), so the packed words add
// exactly, low halves and high halves apart
__device__ __forceinline__ uint32_t prefix16(const uint32_t (&w)[8],
                                             uint32_t k) {
  const uint32_t kw = k >> 1;
  uint32_t acc = 0;
#pragma unroll
  for (uint32_t i = 0; i < 8; i++)
    acc += i < kw ? w[i] : (i == kw && (k & 1)) ? w[i] & 0xffffu : 0u;
  return (acc & 0xffffu) + (acc >> 16);
}

// the number of inclusive prefix sums of the 16 halves that are <= v (the
// index whose half holds v, when v is below the sum of all 16), and the
// largest of them (*below, 0 if none) and the smallest of the others
// (*above): that half's exclusive and inclusive prefix. The prefixes come
// from the running sum of the packed words; the count and the extremes are
// independent per prefix, so they add as trees (no indexed register, which
// the compiler would put in local memory).
__device__ __forceinline__ uint32_t find16(const uint32_t (&w)[8], uint32_t v,
                                           uint32_t* below, uint32_t* above) {
  uint32_t p[8];
  p[0] = w[0];
#pragma unroll
  for (int k = 1; k < 8; k++) p[k] = p[k - 1] + w[k];
  uint32_t cnt = 0, b = 0, a = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint32_t lo = p[k] & 0xffffu;
    const uint32_t i0 = lo + (k ? p[k - 1] >> 16 : 0u), i1 = lo + (p[k] >> 16);
    cnt += (i0 <= v) + (i1 <= v);
    b = max(b, max(i0 <= v ? i0 : 0u, i1 <= v ? i1 : 0u));
    a = min(a, min(i0 > v ? i0 : 0xffffffffu, i1 > v ? i1 : 0xffffffffu));
  }
  *below = b;
  *above = a;
  return cnt;
}

// the encoder's (f, exclusive cum, total) of `sym` in context `ctx`: four
// independent 16-byte loads and (order 1) the total, in one round; order
// 0's total is the caller's tot0
template <int ORDER>
__device__ __forceinline__ void lookup(const Smem<ORDER>& sm, uint32_t ctx,
                                       uint32_t sym, uint32_t tot0,
                                       uint32_t& f, uint32_t& c,
                                       uint32_t& tot) {
  uint32_t gs[8], fr[8];
  load_gsums(sm, ctx, gs);
  load_group(sm, ctx, sym >> 4, fr);
  tot = ORDER ? sm.total[ctx] : tot0;
  const uint32_t before = prefix16(fr, sym & 15);
  c = prefix16(gs, sym >> 4) + before;
  f = prefix16(fr, (sym & 15) + 1) - before;
}

// the decoder's symbol for the value v < tot: the group from the group
// sums, then the symbol from the group's frequencies (two rounds of two
// loads); with its f and exclusive cum
template <int ORDER>
__device__ __forceinline__ uint32_t search(const Smem<ORDER>& sm,
                                           uint32_t ctx, const uint32_t (&gs)[8],
                                           uint32_t v, uint32_t& f,
                                           uint32_t& c) {
  uint32_t base, unused, within, incl;
  const uint32_t grp = find16(gs, v, &base, &unused);
  uint32_t fr[8];
  load_group(sm, ctx, grp, fr);
  const uint32_t k = find16(fr, v - base, &within, &incl);
  f = incl - within;
  c = base + within;
  return grp * 16 + k;
}

// one lane's renormalisation after coding a symbol, in registers: its
// events (at most MAX_EVENTS; arith.cu proves it) with their bytes, low
// byte first; *over where the bound did not hold
__device__ __forceinline__ uint32_t renorm(bool act, uint32_t& low,
                                           uint32_t& rng, uint32_t* bytes,
                                           bool* over) {
  uint32_t e = 0, b = 0;
#pragma unroll
  for (int i = 0; i <= MAX_EVENTS; i++) {
    const bool c1 = (low ^ (low + rng)) < TOP;
    if (!act || !(c1 || rng < BOT)) break;
    if (i == MAX_EVENTS) {
      *over = true;
      break;
    }
    if (!c1) rng = (0u - low) & (BOT - 1);
    b |= (low >> 24) << (8 * i);
    e++;
    low <<= 8;
    rng <<= 8;
  }
  *bytes = b;
  return e;
}

// before barrier A: the warp's counts of lanes with more than 0, 1, 2
// events
__device__ __forceinline__ void publish_counts(uint2* cnt, uint32_t e) {
  const uint32_t c0 = __popc(__ballot_sync(FULL, e > 0));
  const uint32_t c1 = __popc(__ballot_sync(FULL, e > 1));
  const uint32_t c2 = __popc(__ballot_sync(FULL, e > 2));
  if ((threadIdx.x & 31) == 0) cnt[threadIdx.x >> 5] = make_uint2(c0 | c1 << 16, c2);
}

// after barrier A: the slot of this lane's i-th event of the step,
// relative to the step's first (the format's order: iteration, then
// lane), for i < 3; returns the step's events. Lane j of each warp reads
// warp j's counts (0 past the block's warps) and the warp sums them with
// __reduce_add_sync: all warps' for the totals, the warps before its own
// for its offsets.
__device__ __forceinline__ uint32_t event_slots(const uint2* cnt, uint32_t e,
                                                uint32_t (&slot)[MAX_EVENTS]) {
  const uint32_t lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const uint2 c = cnt[lane];
  const uint32_t t01 = __reduce_add_sync(FULL, c.x);
  const uint32_t t2 = __reduce_add_sync(FULL, c.y);
  const uint32_t p01 = __reduce_add_sync(FULL, lane < w ? c.x : 0u);
  const uint32_t p2 = __reduce_add_sync(FULL, lane < w ? c.y : 0u);
  const uint32_t t0 = t01 & 0xffffu, t1 = t01 >> 16;
  const uint32_t lt = lanemask_lt();
  const uint32_t r0 = __popc(__ballot_sync(FULL, e > 0) & lt);
  const uint32_t r1 = __popc(__ballot_sync(FULL, e > 1) & lt);
  const uint32_t r2 = __popc(__ballot_sync(FULL, e > 2) & lt);
  slot[0] = (p01 & 0xffffu) + r0;
  slot[1] = t0 + (p01 >> 16) + r1;
  slot[2] = t0 + t1 + p2 + r2;
  return t0 + t1 + t2;
}

// the active lanes of step s: the first n / K lanes run all K steps, the
// next one the n mod K symbols left (arith_np._lane_layout)
struct ActiveLanes {
  int64_t full, rem;

  __device__ ActiveLanes(int64_t n, int64_t K, int N) {
    full = K ? n / K : 0;
    full = full < N ? full : N;
    rem = full < N ? n - full * K : 0;
  }
  __device__ __forceinline__ uint32_t at(int64_t s) const {
    return (uint32_t)full + (s < rem ? 1u : 0u);
  }
};

template <int ORDER>
__device__ void model_init(Smem<ORDER>& sm) {
  for (int i = threadIdx.x; i < Smem<ORDER>::NCTX * 128; i += blockDim.x)
    sm.words[i] = 0x00010001u;
  for (int i = threadIdx.x; i < Smem<ORDER>::NCTX * 8; i += blockDim.x)
    sm.gsum[i] = 0x00100010u;
  for (int i = threadIdx.x; i < Smem<ORDER>::NCTX; i += blockDim.x)
    sm.total[i] = 256;
  if (threadIdx.x < 32) sm.cnt[threadIdx.x] = make_uint2(0, 0);
  if (threadIdx.x == 0) sm.nlist = 0;
  __syncthreads();
}

// halve context c's row, by one warp: 4 words a lane (lane j holds symbols
// 8j .. 8j + 7, half of group j >> 1); its group sums and total rebuilt
// from the halved words
template <int ORDER>
__device__ __forceinline__ void halve_row(Smem<ORDER>& sm, uint32_t c) {
  const int lane = threadIdx.x & 31;
  uint4* slot = reinterpret_cast<uint4*>(sm.words + c * 128) +
                (ORDER ? lane ^ (c & 7) : lane);
  uint4 x = *slot;
  x.x = halve(x.x); x.y = halve(x.y); x.z = halve(x.z); x.w = halve(x.w);
  *slot = x;
  uint32_t s = x.x + x.y + x.z + x.w;
  s = (s & 0xffffu) + (s >> 16);
  const uint32_t g = s + __shfl_xor_sync(FULL, s, 1);   // group lane >> 1
  const uint32_t g_odd = __shfl_down_sync(FULL, g, 2);  // group + 1
  if ((lane & 3) == 0) sm.gsum[gsum_index(c, lane >> 2)] = g | (g_odd << 16);
  uint32_t tot = s;
#pragma unroll
  for (int d = 16; d; d >>= 1) tot += __shfl_xor_sync(FULL, tot, d);
  if (lane == 0) sm.total[c] = tot;
}

// halve every listed context, one warp a row; ends on a barrier
template <int ORDER>
__device__ void halve_listed(Smem<ORDER>& sm) {
  const int nw = (blockDim.x + 31) >> 5, n = sm.nlist;
  for (int i = threadIdx.x >> 5; i < n; i += nw) halve_row(sm, sm.list[i]);
  __syncthreads();
  if (threadIdx.x == 0) sm.nlist = 0;   // next added to after barrier A
}

// after barrier A: +INC for each active lane's (context, symbol), then
// halve every context that this step took over MAX_TOTAL (addition
// commutes: the batch is deterministic).
// - Order 1: each active lane adds INC to its frequency half, its
//   group-sum half and its context's total with shared atomics. Every total
//   is <= MAX_TOTAL after a step, so exactly one add a context crosses
//   MAX_TOTAL when the step takes it over, and its thread lists the
//   context. Barrier B is the __syncthreads_or of the crossings.
// - Order 0: each active lane adds INC to its frequency half and its
//   group-sum half. The one context's total every thread keeps (tot0): the
//   step adds INC x nact, the block's active lanes, so every thread knows
//   whether it crosses and barrier B is a plain __syncthreads.
// A step that halves takes one more barrier. Returns whether it halved.
template <int ORDER>
__device__ __forceinline__ bool model_update(Smem<ORDER>& sm, bool act,
                                             uint32_t ctx, uint32_t sym,
                                             uint32_t& tot0, uint32_t nact) {
  const uint32_t grp = sym >> 4;
  if (act) {
    atomicAdd(&sm.words[word_index<ORDER>(ctx, sym >> 1)],
              INC << (16 * (sym & 1)));
    atomicAdd(&sm.gsum[gsum_index(ctx, grp >> 1)], INC << (16 * (grp & 1)));
  }
  if (!ORDER) {
    tot0 += INC * nact;
    __syncthreads();                                   // barrier B
    if (tot0 <= MAX_TOTAL) return false;
    if (threadIdx.x < 32) halve_row(sm, 0);
    __syncthreads();
    tot0 = sm.total[0];
    return true;
  }
  bool cross = false;
  if (act) {
    const uint32_t old = atomicAdd(&sm.total[ctx], INC);
    if (old <= MAX_TOTAL && old + INC > MAX_TOTAL) {
      sm.list[atomicAdd(&sm.nlist, 1)] = (int)ctx;
      cross = true;
    }
  }
  if (!__syncthreads_or(cross)) return false;
  halve_listed(sm);
  return true;
}

}  // namespace arithk

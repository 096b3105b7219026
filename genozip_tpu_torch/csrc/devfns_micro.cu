// Chain floors of the ARITH-W32 coder (csrc/arith.cu) and the PBWT
// (csrc/pbwt.cu): kernels that take the serial chain of a coder's steps or
// a transform's rows (the same barriers, ranks, scans and model updates)
// with no symbol coded or value stored; and probes of PR 12's ARITH coder
// (csrc/arith_v1.cuh) and PBWT (csrc/pbwt_v1.cuh) with one piece of a step
// or a row taken out at a time. Only chip_smoke.py, scripts/arith_probe.py
// and scripts/pbwt_probe.py build and run them, to set
// beside the coders' times what the chain and each piece cost; no entry
// point of the package calls them.

#include <cstdint>
#include <cuda_runtime.h>

#include "arith_model.cuh"
#include "arith_v1.cuh"
#include "pbwt_common.cuh"
#include "pbwt_v1.cuh"

namespace arith_floor {

// The chain floor of PR 12's step (csrc/arith_v1.cuh): its renorm barriers
// and ranks with `iters` iterations moving every lane, and its model update
// (the atomics, order 0's block scan, order 1's halving test) on the
// batch's own symbols; no symbol is coded, no byte read or written. The
// symbols come from the encode launch table, one step ahead of their use.
template <int ORDER>
__global__ void __launch_bounds__(arith_v1::MAX_THREADS)
arith_floor_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ meta, int iters,
                   int64_t* sink) {
  using namespace arith_v1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<ORDER>& sm = *reinterpret_cast<Smem<ORDER>*>(smem_raw);
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t n = m[1];
  const int N = 1 << (int)m[4], t = threadIdx.x;
  const int64_t K = n ? (n + N - 1) / N : 0;
  int64_t lane_len = 0;
  if (t < N) {
    lane_len = n - (int64_t)t * K;
    lane_len = lane_len < 0 ? 0 : lane_len > K ? K : lane_len;
  }
  const uint8_t* src = data + m[0] + (int64_t)t * K;
  model_init(sm);
  int64_t ev = 0;
  uint32_t x = 0, prev = 0, cur = lane_len > 0 ? src[0] : 0;
  int parity = 0;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    const uint32_t sym = cur;
    cur = s + 1 < lane_len ? src[s + 1] : 0;
    for (int it = 0;; it++) {
      const bool go = act && it < iters;
      int* ws = sm.wrank[parity];
      parity ^= 1;
      const unsigned b = __ballot_sync(FULL, go);
      if ((t & 31) == 0) ws[t >> 5] = __popc(b);
      if (!__syncthreads_or(go)) break;
      int cnt;
      x += warps_prefix(ws, &cnt) + __popc(b & lanemask_lt());
      ev += cnt;
    }
    model_update(sm, act, ORDER ? prev : 0u, sym);
    prev = sym;
  }
  if (t == 0) sink[blockIdx.x] = ev + x;
}

// A warp-aggregated update: one leader a distinct (context, symbol),
// (context, group) and context, elected by __match_any_sync, adds popc x
// INC (the shipped model_update adds INC a lane); kept for the floor that
// measures it against the shipped one.
template <int ORDER>
__device__ __forceinline__ bool model_update_matched(arithk::Smem<ORDER>& sm,
                                                     bool act, uint32_t ctx,
                                                     uint32_t sym) {
  using namespace arithk;
  constexpr uint32_t NO_KEY = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const uint32_t grp = sym >> 4;
  const unsigned ps = __match_any_sync(FULL, act ? ctx << 8 | sym : NO_KEY);
  const unsigned pg = __match_any_sync(FULL, act ? ctx << 4 | grp : NO_KEY);
  const unsigned pc = ORDER ? __match_any_sync(FULL, act ? ctx : NO_KEY)
                            : __ballot_sync(FULL, act);
  bool cross = false;
  if (act) {
    if (__ffs(ps) - 1 == lane)
      atomicAdd(&sm.words[word_index<ORDER>(ctx, sym >> 1)],
                (INC * __popc(ps)) << (16 * (sym & 1)));
    if (__ffs(pg) - 1 == lane)
      atomicAdd(&sm.gsum[gsum_index(ctx, grp >> 1)],
                (INC * __popc(pg)) << (16 * (grp & 1)));
    if (__ffs(pc) - 1 == lane) {
      const uint32_t add = INC * __popc(pc);
      const uint32_t old = atomicAdd(&sm.total[ctx], add);
      if (old <= MAX_TOTAL && old + add > MAX_TOTAL) {
        sm.list[atomicAdd(&sm.nlist, 1)] = (int)ctx;
        cross = true;
      }
    }
  }
  if (!__syncthreads_or(cross)) return false;
  halve_listed(sm);
  return true;
}

// The update with the warp's commonest keys peeled: up to 4 rounds a key,
// each electing the lowest lane still to add (__shfl_sync, __ballot_sync)
// to add for the lanes of its key, while a round takes more than one lane;
// the lanes left add alone. Kept for the floor that measures it.
__device__ __forceinline__ bool peel(unsigned& todo, uint32_t key,
                                     uint32_t* n) {
  const int lead = __ffs(todo) - 1;
  const uint32_t k0 = __shfl_sync(arithk::FULL, key, lead);
  const unsigned m = __ballot_sync(arithk::FULL, key == k0) & todo;
  const int lane = threadIdx.x & 31;
  if (lane == lead) *n = __popc(m);
  else if ((m >> lane) & 1) *n = 0;
  todo &= ~m;
  return __popc(m) > 1;
}

template <int ORDER>
__device__ __forceinline__ bool model_update_peeled(arithk::Smem<ORDER>& sm,
                                                    bool act, uint32_t ctx,
                                                    uint32_t sym) {
  using namespace arithk;
  const uint32_t grp = sym >> 4;
  const uint32_t ks = ctx << 8 | sym, kg = ctx << 4 | grp;
  const unsigned active = __ballot_sync(FULL, act);
  unsigned ts = active, tg = active, tc = ORDER ? active : 0u;
  uint32_t ns = 1, ng = 1, nc = 1;
#pragma unroll
  for (int p = 0; p < 4; p++) {
    const bool ms = ts && peel(ts, ks, &ns);
    const bool mg = tg && peel(tg, kg, &ng);
    const bool mc = tc && peel(tc, ctx, &nc);
    if (!ms) ts = 0;
    if (!mg) tg = 0;
    if (!mc) tc = 0;
    if (!(ts | tg | tc)) break;
  }
  if (act && ns)
    atomicAdd(&sm.words[word_index<ORDER>(ctx, sym >> 1)],
              (INC * ns) << (16 * (sym & 1)));
  if (act && ng)
    atomicAdd(&sm.gsum[gsum_index(ctx, grp >> 1)],
              (INC * ng) << (16 * (grp & 1)));
  uint32_t add = INC * nc;
  bool owner = act && nc;
  if (!ORDER) {
    add = INC * __popc(active);
    owner = active && (threadIdx.x & 31) == __ffs(active) - 1;
  }
  bool cross = false;
  if (owner) {
    const uint32_t old = atomicAdd(&sm.total[ctx], add);
    if (old <= MAX_TOTAL && old + add > MAX_TOTAL) {
      sm.list[atomicAdd(&sm.nlist, 1)] = (int)ctx;
      cross = true;
    }
  }
  if (!__syncthreads_or(cross)) return false;
  halve_listed(sm);
  return true;
}

// The chain floor of the shipped step (csrc/arith.cu on arith_model.cuh):
// the counts, barrier A, the event slots, the update on the batch's own
// symbols, barrier B and the halving, with `iters` events a lane; no
// symbol is coded, no byte read or written. UPD 0: the shipped update; 1:
// the warp-aggregated one (model_update_matched); 2: none (barrier B
// alone); 3: the peeled one (model_update_peeled).
template <int ORDER, int UPD>
__global__ void __launch_bounds__(arithk::MAX_THREADS)
arith_floor2_kernel(const uint8_t* __restrict__ data,
                    const int64_t* __restrict__ meta, int iters,
                    int64_t* sink) {
  using namespace arithk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<ORDER>& sm = *reinterpret_cast<Smem<ORDER>*>(smem_raw);
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t n = m[1];
  const int N = 1 << (int)m[4], t = threadIdx.x;
  const int64_t K = n ? (n + N - 1) / N : 0;
  int64_t lane_len = 0;
  if (t < N) {
    lane_len = n - (int64_t)t * K;
    lane_len = lane_len < 0 ? 0 : lane_len > K ? K : lane_len;
  }
  const uint8_t* src = data + m[0] + (int64_t)t * K;
  model_init(sm);
  const ActiveLanes lanes(n, K, N);
  int64_t ev = 0;
  uint32_t x = 0, prev = 0, tot0 = 256, cur = lane_len > 0 ? src[0] : 0;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    const uint32_t sym = cur;
    cur = s + 1 < lane_len ? src[s + 1] : 0;
    const uint32_t e = act ? (uint32_t)iters : 0u;
    publish_counts(sm.cnt, e);
    __syncthreads();
    uint32_t slot[MAX_EVENTS];
    ev += event_slots(sm.cnt, e, slot);
    x += slot[0] + slot[1] + slot[2];
    if (UPD == 0) model_update(sm, act, ORDER ? prev : 0u, sym, tot0,
                               lanes.at(s));
    else if (UPD == 1) model_update_matched(sm, act, ORDER ? prev : 0u, sym);
    else if (UPD == 3) model_update_peeled(sm, act, ORDER ? prev : 0u, sym);
    else __syncthreads_or(false);
    prev = sym;
  }
  if (t == 0) sink[blockIdx.x] = ev + x + tot0;
}

}  // namespace arith_floor

namespace arith_probe {

// PR 12's arith_encode / arith_decode (csrc/arith_v1.cuh) with one piece
// taken out at a time, to see what each costs; a probe's output is not a
// stream. VAR bits:
//   NO_WALK: c (and the decoder's symbol) from one shared word instead of
//     order 1's row walk, order 0's cumulative row or its binary search;
//   NO_GLOBAL: the encoder loads its symbol one step ahead and writes no
//     byte; the decoder reads no event byte (0) and writes no symbol;
//   FIXED_RENORM: each lane renormalises alone in registers, then one
//     block rank (one barrier) places its events, instead of a barrier an
//     iteration and one to leave.
using namespace arith_v1;
enum { NO_WALK = 1, NO_GLOBAL = 2, FIXED_RENORM = 4 };

template <int ORDER>
__device__ __forceinline__ void lookup_word(const Smem<ORDER>& sm,
                                            uint32_t ctx, uint32_t sym,
                                            uint32_t tot, uint32_t& f,
                                            uint32_t& c) {
  f = half_of(sm.words[word_index<ORDER>(ctx, sym >> 1)], sym);
  c = (sym * (tot - f)) >> 8;           // in [0, tot - f]
}

// the step's renormalisation; put(i, rank, low) takes the lane's i-th
// event of the step (the byte is low >> 24) and its rank among the step's
// events, or rank -1 and then again with its rank (FIXED_RENORM). Returns
// the step's events.
template <int ORDER, int VAR, typename Put>
__device__ __forceinline__ int64_t probe_renorm(Smem<ORDER>& sm, int& parity,
                                                bool act, uint32_t& low,
                                                uint32_t& rng, Put put) {
  const int t = threadIdx.x;
  if (VAR & FIXED_RENORM) {
    uint32_t bytes, slot[arithk::MAX_EVENTS];
    bool over = false;
    const uint32_t e = arithk::renorm(act, low, rng, &bytes, &over);
    for (uint32_t i = 0; i < e; i++) put(i, -1, (bytes >> (8 * i)) << 24);
    arithk::publish_counts(sm.cnt, e);
    __syncthreads();
    const uint32_t step_ev = arithk::event_slots(sm.cnt, e, slot);
    for (uint32_t i = 0; i < e; i++) put(i, (int)slot[i], 0u);
    return step_ev;
  }
  int64_t ev = 0;
  for (uint32_t i = 0;; i++) {
    const bool c1 = (low ^ (low + rng)) < TOP;
    const bool go = act && (c1 || rng < BOT);
    int* ws = sm.wrank[parity];
    parity ^= 1;
    const unsigned b = __ballot_sync(FULL, go);
    if ((t & 31) == 0) ws[t >> 5] = __popc(b);
    if (!__syncthreads_or(go)) break;
    int cnt;
    const int rk = warps_prefix(ws, &cnt) + __popc(b & lanemask_lt());
    if (go) {
      if (!c1) rng = (0u - low) & (BOT - 1);
      put(i, (int)ev + rk, low);
      low <<= 8;
      rng <<= 8;
    }
    ev += cnt;
  }
  return ev;
}

template <int ORDER, int VAR>
__global__ void __launch_bounds__(MAX_THREADS)
probe_encode(const uint8_t* __restrict__ data,
             const int64_t* __restrict__ meta, uint8_t* __restrict__ out,
             int64_t* __restrict__ lens) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<ORDER>& sm = *reinterpret_cast<Smem<ORDER>*>(smem_raw);
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t in_off = m[0], n = m[1], out_off = m[2], cap = m[3];
  const int N = 1 << (int)m[4];
  const int64_t K = n ? (n + N - 1) / N : 0;
  const int t = threadIdx.x;
  int64_t lane_len = 0;
  if (t < N) {
    lane_len = n - (int64_t)t * K;
    lane_len = lane_len < 0 ? 0 : lane_len > K ? K : lane_len;
  }
  const uint8_t* src = data + in_off + (int64_t)t * K;
  uint8_t* body = out + out_off + HEADER;
  const int64_t body_cap = cap - HEADER;
  model_init(sm);
  uint32_t low = 0, rng = 0xffffffffu, prev = 0, nev = 0;
  uint32_t cur = lane_len > 0 ? src[0] : 0;
  int64_t ev = 0;
  int64_t ring[4] = {0, 0, 0, 0};
  bool overflow = false;
  int parity = 0;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    uint32_t sym;
    if (VAR & NO_GLOBAL) {
      sym = cur;
      cur = s + 1 < lane_len ? src[s + 1] : 0;
    } else {
      sym = act ? src[s] : 0;
    }
    const uint32_t ctx = ORDER ? prev : 0;
    if (act) {
      uint32_t f, c, tot;
      if (VAR & NO_WALK) {
        tot = ORDER ? sm.aux[ctx] : sm.aux[256];
        lookup_word(sm, ctx, sym, tot, f, c);
      } else {
        lookup(sm, ctx, sym, f, c, tot);
      }
      const uint32_t r = rng / tot;
      low += c * r;
      rng = f * r;
    }
    const uint32_t nev0 = nev;
    ev += probe_renorm<ORDER, VAR>(sm, parity, act, low, rng,
        [&](uint32_t i, int rk, uint32_t lw) {
          if (rk < 0 || !(VAR & FIXED_RENORM)) {   // the byte goes out
            if (!(VAR & NO_GLOBAL))
              put(body, body_cap, N, t, nev0 + i, ring, (uint8_t)(lw >> 24),
                  overflow);
            nev = nev0 + i + 1;
          }
          if (rk >= 0) ring_set(ring, nev0 + i, ev + rk);
        });
    model_update(sm, act, ctx, sym);
    prev = sym;
  }
  if (t < N && !(VAR & NO_GLOBAL)) {
    for (uint32_t k = 0; k < 4; k++) {
      put(body, body_cap, N, t, nev + k, ring, (uint8_t)(low >> 24),
          overflow);
      low <<= 8;
    }
  }
  overflow = __syncthreads_or(overflow);
  if (t == 0) {
    uint8_t* h = out + out_off;
    h[0] = (uint8_t)m[4];
    h[1] = (uint8_t)ORDER;
    for (int k = 0; k < 4; k++) h[2 + k] = (uint8_t)((uint64_t)n >> (8 * k));
    lens[blockIdx.x] = overflow ? -1 : HEADER + 4 * N + ev;
  }
}

template <int ORDER, int VAR>
__global__ void __launch_bounds__(MAX_THREADS)
probe_decode(const uint8_t* __restrict__ bufs,
             const int64_t* __restrict__ meta, uint8_t* __restrict__ out,
             int64_t* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<ORDER>& sm = *reinterpret_cast<Smem<ORDER>*>(smem_raw);
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t body_off = m[0], blen = m[1], out_off = m[2], n = m[3];
  const int N = 1 << (int)m[4];
  const int64_t K = n ? (n + N - 1) / N : 0;
  const int t = threadIdx.x;
  const uint8_t* body = bufs + body_off;
  int64_t lane_len = 0;
  uint32_t code = 0;
  if (t < N) {
    lane_len = n - (int64_t)t * K;
    lane_len = lane_len < 0 ? 0 : lane_len > K ? K : lane_len;
    code = ((uint32_t)body[4 * t] << 24) | ((uint32_t)body[4 * t + 1] << 16) |
           ((uint32_t)body[4 * t + 2] << 8) | body[4 * t + 3];
  }
  uint8_t* dst = out + out_off + (int64_t)t * K;
  model_init(sm);
  uint32_t low = 0, rng = 0xffffffffu, prev = 0;
  int64_t ptr = 4 * (int64_t)N;
  bool bad = false;
  int parity = 0;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    const uint32_t ctx = ORDER ? prev : 0;
    uint32_t sym = 0;
    if (act) {
      uint32_t tot = ORDER ? sm.aux[ctx] : sm.aux[256];
      tot = tot ? tot : 1;
      const uint32_t r = rng / tot;
      uint32_t v = (code - low) / (r ? r : 1);
      v = v < tot - 1 ? v : tot - 1;
      uint32_t f, c;
      if (VAR & NO_WALK) {
        sym = (v << 8) / tot;
        lookup_word(sm, ctx, sym, tot, f, c);
      } else {
        sym = search(sm, ctx, v, f, c);
      }
      low += c * r;
      rng = f * r;
      if (!(VAR & NO_GLOBAL)) dst[s] = (uint8_t)sym;
    }
    ptr += probe_renorm<ORDER, VAR>(sm, parity, act, low, rng,
        [&](uint32_t, int rk, uint32_t) {
          if (rk < 0) return;
          const int64_t pos = ptr + rk;
          uint32_t byte = 0;
          if (pos >= blen) bad = true;
          else if (!(VAR & NO_GLOBAL)) byte = body[pos];
          code = (code << 8) | byte;
        });
    model_update(sm, act, ctx, sym);
    prev = sym;
  }
  bad = __syncthreads_or(bad);
  if (t == 0) status[blockIdx.x] = bad ? -1 : n;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const void* in, const void* meta,
           int R, int threads, void* out, void* res, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<R, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const int64_t*)meta, (uint8_t*)out,
      (int64_t*)res);
  return (int)cudaGetLastError();
}

template <int ORDER, int VAR>
int run(int decode, const void* in, const void* meta, int R, int threads,
        void* out, void* res, void* stream) {
  const size_t smem = sizeof(Smem<ORDER>);
  return decode ? launch(probe_decode<ORDER, VAR>, smem, in, meta, R, threads,
                         out, res, stream)
                : launch(probe_encode<ORDER, VAR>, smem, in, meta, R, threads,
                         out, res, stream);
}

template <int ORDER>
int run_var(int var, int decode, const void* in, const void* meta, int R,
            int threads, void* out, void* res, void* stream) {
  switch (var) {
    case 0: return run<ORDER, 0>(decode, in, meta, R, threads, out, res, stream);
    case NO_WALK:
      return run<ORDER, NO_WALK>(decode, in, meta, R, threads, out, res, stream);
    case NO_GLOBAL:
      return run<ORDER, NO_GLOBAL>(decode, in, meta, R, threads, out, res,
                                   stream);
    case FIXED_RENORM:
      return run<ORDER, FIXED_RENORM>(decode, in, meta, R, threads, out, res,
                                      stream);
    case NO_WALK | NO_GLOBAL | FIXED_RENORM:
      return run<ORDER, NO_WALK | NO_GLOBAL | FIXED_RENORM>(
          decode, in, meta, R, threads, out, res, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace arith_probe

namespace pbwt_floor {

// the chain floor of PR 12's row (csrc/pbwt_v1.cuh): the barriers, warp
// matches and column scans of `rows` rows of H values, with no value loaded
// or stored
__global__ void __launch_bounds__(pbwt_v1::MAX_THREADS)
pbwt_floor_v1_kernel(int64_t rows, int H, int64_t* sink) {
  using namespace pbwt_v1;
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

// the chain floor of the shipped encoder's row (csrc/pbwt.cu): its sort
// (pbwtk::sort_row: ranks, barrier 1, place, the scatter of perm into
// shared memory; the helper warp's next row's flags and code table) and
// barrier 2, on values
// made from (row, position) (0, 1 and 254, as a GT row), with nothing
// loaded from or stored to device memory
__device__ __forceinline__ int floor_value(int64_t i, int j) {
  const int x = (int)i ^ j;
  return (x & 63) == 5 ? 254 : (x & 3) == 0;
}

template <int SEG>
__global__ void __launch_bounds__(pbwtk::MAX_THREADS)
pbwt_floor_v2_kernel(int64_t rows, int H, int64_t* sink) {
  using namespace pbwtk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, T = blockDim.x, nw = (T >> 5) - 1;
  const int ns = 32 * nw;
  Tables tb;
  tb.carve(smem_raw, nw);
  uint16_t* dst = reinterpret_cast<uint16_t*>(smem_raw + table_bytes(nw));
  __syncthreads();
  for (int j = t; j < H; j += T) tb.row_flags(0)[floor_value(0, j)] = 1;
  __syncthreads();
  if (t >= ns) {
    const int np = code_table(tb.row_flags(0), tb.row_codes(0));
    if (t == ns) tb.np[0] = np;
  }
  __syncthreads();
  for (int64_t i = 0; i < rows; i++) {
    if (t >= ns) {
      uint8_t* f = tb.row_flags(i + 1);
#pragma unroll 4
      for (int j = t - ns; j < H; j += 32) f[floor_value(i + 1, j)] = 1;
      helper_row(tb, i, true);
    } else {
      const int np = tb.np[i & 1];
      sort_row<SEG, 2>(
          tb, np, tb.row_codes(i), H,
          [&](int j, bool, int& v, int& pay) {
            v = floor_value(i, j);
            pay = j;
          },
          [&](int d, int pay) { dst[d] = (uint16_t)pay; }, [] {});
    }
    __syncthreads();
  }
  if (t == 0) sink[blockIdx.x] = dst[0] + dst[H - 1];
}

// the chain floor of the decoder's row: `group` rows a barrier, each row
// a gather of perm[H - 1 - j] and a staged byte at it (one shared-memory
// gather a row), then perm_new[j] = perm[H - 1 - j] and the barrier; group
// 1 is a row a barrier
__global__ void __launch_bounds__(pbwtk::MAX_THREADS)
pbwt_floor_v3_kernel(int64_t rows, int H, int group, int64_t* sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* src = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* dst = src + pbwtk::SMEM_H;
  uint8_t* stage = reinterpret_cast<uint8_t*>(dst + pbwtk::SMEM_H);
  const int t = threadIdx.x, T = blockDim.x;
  for (int j = t; j < H; j += T) src[j] = (uint16_t)j;
  __syncthreads();
  for (int64_t i = 0; i < rows; i += group) {
    for (int k = 1; k < group; k++)
      for (int j = t; j < H; j += T) stage[src[H - 1 - j]] = (uint8_t)k;
    for (int j = t; j < H; j += T) dst[j] = src[H - 1 - j];
    __syncthreads();
    uint16_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  if (t == 0) sink[blockIdx.x] = src[0] + stage[0];
}

}  // namespace pbwt_floor

extern "C" {

// the chain floor of PR 12's step (version 1) or of the shipped step
// (version 2; 3 with the warp-aggregated update, 4 with none, 5 with the
// peeled one) on R streams
// of an encode launch table (arith_torch's), with `iters` renorm events a
// lane a step (0 or 1)
int arith_step_floor(int version, int order, const void* data,
                     const void* meta, int R, int iters, int threads,
                     void* sink, void* stream) {
  using namespace arith_floor;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = version == 1
      ? (order ? sizeof(arith_v1::Smem<1>) : sizeof(arith_v1::Smem<0>))
      : (order ? sizeof(arithk::Smem<1>) : sizeof(arithk::Smem<0>));
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<R, threads, smem, st>>>((const uint8_t*)data,
                                     (const int64_t*)meta, iters,
                                     (int64_t*)sink);
    return (int)cudaGetLastError();
  };
  if (version == 1)
    return order ? go(arith_floor_kernel<1>) : go(arith_floor_kernel<0>);
  if (version == 3)
    return order ? go(arith_floor2_kernel<1, 1>)
                 : go(arith_floor2_kernel<0, 1>);
  if (version == 4)
    return order ? go(arith_floor2_kernel<1, 2>)
                 : go(arith_floor2_kernel<0, 2>);
  if (version == 5)
    return order ? go(arith_floor2_kernel<1, 3>)
                 : go(arith_floor2_kernel<0, 3>);
  return order ? go(arith_floor2_kernel<1, 0>) : go(arith_floor2_kernel<0, 0>);
}

// PR 12's coder with the pieces of `var` (arith_probe's bits; 0, one bit or
// all three) taken out: an encode (decode = 0) or decode launch of its table
int arith_probe_run(int var, int order, int decode, const void* in,
                    const void* meta, int R, int threads, void* out,
                    void* res, void* stream) {
  return order ? arith_probe::run_var<1>(var, decode, in, meta, R, threads,
                                         out, res, stream)
               : arith_probe::run_var<0>(var, decode, in, meta, R, threads,
                                         out, res, stream);
}

// the chain floor of a PBWT row on R blocks of `threads` threads: version
// 1 PR 12's row (pbwt_floor_v1_kernel), 2 the shipped encoder's
// (pbwt_floor_v2_kernel; a sorting warp and the helper at least, H <= 16
// sorting threads and SMEM_H), 3 the decoder's
// chain (pbwt_floor_v3_kernel; H <= SMEM_H) at `group` rows a barrier
int pbwt_row_floor(int version, int group, long long rows, int H,
                   int threads, int R, void* sink, void* stream) {
  using namespace pbwt_floor;
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto kernel, size_t smem, auto... args) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<R, threads, smem, st>>>(rows, H, args..., (int64_t*)sink);
    return (int)cudaGetLastError();
  };
  if (threads < 32 || threads > 1024 || threads % 32 || H < 1)
    return (int)cudaErrorInvalidValue;
  if (version == 1)
    return threads < pbwt_v1::MIN_THREADS
               ? (int)cudaErrorInvalidValue
               : go(pbwt_floor_v1_kernel, sizeof(pbwt_v1::Smem));
  if (version == 2 && H <= pbwtk::SMEM_H && threads >= 64) {
    const int nw = threads / 32 - 1;
    const size_t smem = pbwtk::table_bytes(nw) + 2 * pbwtk::SMEM_H;
    switch (pbwtk::seg_class(H, nw)) {
      case 1: return go(pbwt_floor_v2_kernel<1>, smem);
      case 2: return go(pbwt_floor_v2_kernel<2>, smem);
      case 4: return go(pbwt_floor_v2_kernel<4>, smem);
      case 8: return go(pbwt_floor_v2_kernel<8>, smem);
      case 16: return go(pbwt_floor_v2_kernel<16>, smem);
    }
  }
  if (version == 3 && H <= pbwtk::SMEM_H && group >= 1)
    return go(pbwt_floor_v3_kernel, 5 * pbwtk::SMEM_H, group);
  return (int)cudaErrorInvalidValue;
}

// PR 12's PBWT (csrc/pbwt_v1.cuh) with the pieces of `var` (pbwt_v1's
// bits; 0 or one bit) taken out: an encode (decode = 0) or decode launch of
// a pbwt_torch launch table as PR 12 laid it out (2 H words of scratch a
// matrix past 4,096 values)
int pbwt_probe_run(int var, int decode, const void* in, void* out,
                   const void* meta, int R, int threads, void* work,
                   void* stream) {
  return decode ? pbwt_v1::run_var<true>(var, in, out, meta, R, threads,
                                         work, stream)
                : pbwt_v1::run_var<false>(var, in, out, meta, R, threads,
                                          work, stream);
}

}  // extern "C"

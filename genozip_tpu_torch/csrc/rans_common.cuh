// Constants, the per-step word ranking, the decoders' packed slot entries
// and their renorm-word ring, and the encoders' scratch layout, packed
// entries, stripe and per-lane pass, shared by the rANS kernels (rans.cu)
// and their microbenchmarks (rans_micro.cu).
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

// ---- the encoders ----------------------------------------------------------
//
// Encode meta row: data_off, n, N, K, out_off, state_off, out_len, 0.

constexpr int EB = 128;                  // threads (lanes) per pass-1 block
constexpr int SB = 8;                    // steps a lane's row word holds
constexpr int64_t ENC_PAD = SB * NT * JMAX + 64;

// Stream r's place in the encoders' scratch: its Kp*N < n + 8N bytes of
// rows (Kp = K rounded up to SB) at byte enc_base, its Kp*N u16 renorm
// words, in the rows' layout, at element enc_base, its K*ceil(N/32) emit
// masks at u32 element enc_base/16 and the sums of its Kp/8 scan chunks (a
// chunk: the masks of 8 steps) at u32 element (enc_base >> 7) + r.
// Consecutive bases differ by at least n + ENC_PAD - 15, so no two streams'
// regions meet.
__host__ __device__ __forceinline__ int64_t enc_base(const int64_t* m, int r) {
  return (m[0] + (int64_t)r * ENC_PAD + 15) & ~(int64_t)15;
}

// The work buffer of one encode launch of R streams of n symbols in all;
// ops/rans_cuda.py encode_work_bytes() gives its size: order 1's packed
// entries (512 KB a stream), then T bytes of rows, 2T of words, T/4 of
// masks and the chunk sums, T = n + R * ENC_PAD rounded up to 64.
struct EncWork {
  uint2* ent;
  uint8_t* rows;
  uint16_t* words;
  uint32_t* masks;
  uint32_t* sums;

  __host__ __device__ EncWork(void* work, int order, int R, int64_t n) {
    const int64_t T = (n + (int64_t)R * ENC_PAD + 63) & ~(int64_t)63;
    uint8_t* b = (uint8_t*)work;
    ent = (uint2*)b;
    rows = b + (order == 1 ? ((int64_t)R << 19) : 0);
    words = (uint16_t*)(rows + T);
    masks = (uint32_t*)(rows + 3 * T);
    sums = (uint32_t*)(rows + 3 * T + T / 4);   // (T >> 7) + R + 1 of them
  }
};

// Packed encode entry of a symbol of frequency f and cumulative frequency c:
// x / f by Granlund-Montgomery's round-up reciprocal, exact for every u32
// x >= 1. With l = ceil(log2 f) and m = ceil(2^(32+l) / f) - 2^32,
//   hi = umulhi(x, m),  q = (hi + ((x - hi) >> 1)) >> (l - 1) = x / f,
// and x' = (q << 12) + x % f + c = x + bias + q * (4096 - f), bias = c.
// f = 1 takes m = 2^32 - 1 and shift 0, which gives q = x - 1, and folds the
// missing 1 into bias = c + 4095. .x = f | bias << 13 | shift << 26 (f and
// bias 13 bits, f = 4096 included), .y = m; f = 0 gives 0.
__device__ __forceinline__ uint2 enc_entry(uint32_t f, uint32_t c) {
  if (f == 0) return make_uint2(0u, 0u);
  if (f == 1) return make_uint2(1u | ((c + 4095u) << 13), 0xffffffffu);
  const uint32_t l = 32u - __clz(f - 1u);
  const uint64_t M = ((1ull << (32 + l)) + f - 1u) / f;
  return make_uint2(f | (c << 13) | ((l - 1u) << 26),
                    (uint32_t)(M - (1ull << 32)));
}

// Order-1 entries, 65,536 a stream (512 KB), from the [ctx][sym] freq and
// cum tables: grid (256, R), 256 threads.
__global__ void __launch_bounds__(256)
o1_enc_entries_kernel(const int32_t* __restrict__ tab, uint2* __restrict__ ent) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * 256 + threadIdx.x;     // ctx * 256 + sym
  const int32_t* t = tab + (int64_t)r * 2 * 65536;
  ent[((int64_t)r << 16) + i] = enc_entry((uint32_t)t[i], (uint32_t)t[65536 + i]);
}

// Symbols of R streams -> their rows: for each block of SB = 8 steps, the
// lanes' 8 symbols side by side, rows[(t/8)*8N + 8l + t%8] = d[l*K + t] (0
// past the lane's chunk and in the top block's steps K .. Kp-1), so that
// pass 1 reads a lane's 8 symbols with one 8-byte load and a warp reads 256
// contiguous bytes. A block takes 32 lanes x 64 steps through shared
// memory: the reads of each lane's chunk and the 8-byte row writes cover
// whole sectors. Grid (any, R), 256 threads.
__global__ void __launch_bounds__(256)
stripe_kernel(const int64_t* __restrict__ meta, const uint8_t* __restrict__ data,
              uint8_t* __restrict__ rows) {
  constexpr int TS = 64, PITCH = 72;             // steps a tile, row pitch
  __shared__ __align__(8) uint8_t tile[32][PITCH];
  const int r = blockIdx.y;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t n = m[1], N = m[2], K = m[3];
  const int64_t nb = (K + SB - 1) / SB;          // blocks of 8 steps
  const uint8_t* d = data + m[0];
  uint2* rw = (uint2*)(rows + enc_base(m, r));   // block b of lane l: b*N + l
  const int64_t nl = (N + 31) / 32, tiles = nl * ((nb * SB + TS - 1) / TS);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int64_t b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int64_t l0 = (b % nl) * 32, t0 = (b / nl) * TS;
#pragma unroll
    for (int q = 0; q < 8; ++q) {                // lane ty + 8(q/2), steps tx
      const int i = ty + 8 * (q >> 1), s = tx + 32 * (q & 1);
      const int64_t l = l0 + i, t = t0 + s, g = l * K + t;
      tile[i][s] = l < N && t < K && g < n ? d[g] : 0;
    }
    __syncthreads();
    // thread (lane tx, block ty) writes that lane's 8 steps of the block
    const int64_t l = l0 + tx, blk = t0 / SB + ty;
    if (l < N && blk < nb) rw[blk * N + l] = *(const uint2*)&tile[tx][SB * ty];
    __syncthreads();
  }
}

// Pass 1: one thread per lane runs all K steps of its lane, t = K-1 .. 0,
// with its state in a register. A lane's arithmetic never reads the word
// pointer, so no step waits on another lane: each step is one entry, the
// emit compare, one umulhi, shifts and one multiply-add. Steps run in
// batches of the SB = 8 steps of a row word, top block first (its steps K ..
// Kp-1 do nothing), so one 8-byte load brings a batch's symbols; an entry's
// address depends only on symbols, so while batch b computes, the entries
// of batch b - 1 and the row word of batch b - 3 are in flight. The steps
// are straight-line code, selects in place of branches, so that the
// compiler interleaves one step's entry fields with another step's chain.
// After the batch's last step the lane's 8 words (the state's low half
// before each step, used where the step emitted) go out in one 16-byte
// store to words[(t/8)*8N + 8l + t%8], the rows' layout, and lane u stores
// the warp's emit mask of the batch's step 8b+7-u to masks[t*ceil(N/32) +
// l/32]: one load and two stores a batch, since a warp has few scoreboards
// for loads in flight and each store instruction holds up the warp.
// rans.cu's scan and scatter put the words in place. Final states go to states. Offsets within a stream are
// 32-bit products widened into the address (Kp*N < n + 8N < 2^32). Grid
// (MAX_LANES / EB, R), EB threads; blocks and warps past the stream's N
// leave at once. STORE = false drops the word stores (a microbenchmark).
template <int ORDER, bool STORE>
__global__ void __launch_bounds__(EB)
encode_lanes_kernel(const int64_t* __restrict__ meta,
                    const int32_t* __restrict__ tab,
                    const uint8_t* __restrict__ rows_all,
                    const uint2* __restrict__ ent_all,
                    uint16_t* __restrict__ words_all,
                    uint32_t* __restrict__ masks_all,
                    uint32_t* __restrict__ states) {
  constexpr int U = SB;
  __shared__ uint2 s_ent[256];                      // order 0
  const int r = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t n = m[1];
  const uint32_t N = (uint32_t)m[2], K = (uint32_t)m[3];
  const uint32_t l0 = blockIdx.x * EB;
  if (l0 >= N) return;
  if (ORDER == 0) {
    const int32_t* t0 = tab + (int64_t)r * 512;
    for (int i = tid; i < 256; i += EB)
      s_ent[i] = enc_entry((uint32_t)t0[i], (uint32_t)t0[256 + i]);
    __syncthreads();
  }
  const uint32_t l = l0 + tid;
  if (l0 + (tid & ~31) >= N) return;                // a warp past N (N < EB)
  const bool live = l < N;                          // N = 16: half a warp
  const int64_t rest = n - (int64_t)l * K;          // symbols from l*K on
  const int len = !live || rest < 0 ? 0 : rest > K ? (int)K : (int)rest;
  const int64_t base = enc_base(m, r);
  const uint32_t nw = (N + 31) >> 5;
  const uint2* rw = (const uint2*)(rows_all + base) + l;   // block b at b*N
  uint4* wd = (uint4*)(words_all + base) + l;       // block b at b*N
  uint32_t* mk = masks_all + (base >> 4) + (l >> 5);
  const uint2* ent = ent_all + ((int64_t)r << 16);  // order 1

  // the lane's row word of block b (steps 8b .. 8b+7, byte j step 8b+j);
  // 0 below block 0, whose top byte is the context of step 0
  auto word = [&](int b) -> uint2 {
    return b >= 0 && live ? rw[(uint64_t)(uint32_t)b * N] : make_uint2(0u, 0u);
  };
  auto byte = [](uint2 w, int j) -> uint32_t {
    return ((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xffu;
  };
  // step 8b + 7 - u's entry, u = 0 .. 7, from block b's word and the top
  // byte of block b - 1 (the context of step 8b)
  auto entries = [&](uint2 w, uint2 below, uint2 (&e)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = U - 1 - u;
      const uint32_t s = byte(w, j), c = j ? byte(w, j - 1) : byte(below, 7);
      e[u] = ORDER == 0 ? s_ent[s] : __ldg(ent + ((c << 8) | s));
    }
  };
  const int nb = (int)(K + U - 1) / U;
  uint2 w1 = word(nb - 2), w2 = word(nb - 3);       // blocks b - 1, b - 2
  uint2 ec[U];                                      // block b's entries
  entries(word(nb - 1), w1, ec);
  uint32_t x = RANS_L;
  for (int b = nb - 1; b >= 0; --b) {
    const uint2 w3 = word(b - 3);                   // in flight
    uint2 en[U];                                    // block b - 1's entries
    entries(w1, w2, en);
    const int tb = U * b + U - 1;                   // the batch's top step
    uint32_t wv[U], mine = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tu = tb - u;
      const uint32_t f = ec[u].x & 0x1fffu, bias = (ec[u].x >> 13) & 0x1fffu;
      const bool act = tu < len;
      // f << 20 in 64 bits: a one-symbol alphabet has f = 4096
      const bool emit = act && (uint64_t)x >= ((uint64_t)f << 20);
      const uint32_t mask = __ballot_sync(0xffffffffu, emit);
      mine = lane == u ? mask : mine;               // lane u keeps step tu's
      wv[u] = x;
      const uint32_t xs = emit ? x >> 16 : x;
      const uint32_t hi = __umulhi(xs, ec[u].y);
      const uint32_t q = (hi + ((xs - hi) >> 1)) >> (ec[u].x >> 26);
      const uint32_t xn = xs + bias + q * ((1u << SCALE_BITS) - f);
      x = act ? xn : xs;
    }
    const uint32_t tl = (uint32_t)(tb - lane);
    if (lane < U && tl < K) mk[(uint64_t)tl * nw] = mine;
    // word j of the block is step 8b + j's, held in wv[7 - j]
    if (STORE && live)
      wd[(uint64_t)(uint32_t)b * N] = make_uint4(
          __byte_perm(wv[7], wv[6], 0x5410), __byte_perm(wv[5], wv[4], 0x5410),
          __byte_perm(wv[3], wv[2], 0x5410), __byte_perm(wv[1], wv[0], 0x5410));
#pragma unroll
    for (int u = 0; u < U; ++u) ec[u] = en[u];
    w1 = w2;
    w2 = w3;
  }
  if (live) states[m[5] + l] = x;
}

}  // namespace rans

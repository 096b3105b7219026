// ARITH-W32 adaptive range coder: two hand-written Hopper kernels (sm_90a),
// arith_encode<order> and arith_decode<order>, order 0 and 1.
//
// The function is genozip_tpu's N-lane adaptive range coder
// (genozip_tpu/ops/arith_jax.py `_encode_device` :86 and `_decode_device`
// :124, XLA device functions under lax.scan; no Pallas kernel), whose
// normative spec is ops/arith_np.py: N carryless 32-bit range-coder lanes
// (TOP = 2^24, BOT = 2^16) over contiguous chunks of the input, in lockstep,
// all sharing one adaptive model, 256 frequencies a context (order 0: one
// context; order 1: the previous byte of the lane's chunk, 0 first). After
// each step the model takes +INC for every (context, symbol) an active lane
// coded, then every context whose total exceeds MAX_TOTAL is halved,
// (f + 1) >> 1, until none does. A step renormalises with `while any(go)`,
// and the stream holds the bytes in decoder order: 4 N initial bytes, lane
// after lane, then one byte an event in the order (step, iteration, lane).
// The plain version is ops/arith_torch.py; the two are byte-equal, and
// equal to arith_np.encode and native.arith_encode.
//
// What bounds it on the H100: neither bytes (n in, about n out) nor
// operations (about 20 integer operations a symbol that the function
// needs), but the chain of K = n / N steps: the model a step reads is the
// one every lane's previous symbol updated, so no lane runs ahead of a
// step's barriers. At the main path's R = 8 streams of 256 KiB (N = 256,
// K = 1024) the operation bound is about 0.0025 ms, one ns a step; even a
// step of 0.23 us (PR 12's measured floor) makes the chain 0.24 ms, so no
// design reaches half that bound there: the yardstick is the step's time
// against the chain floor that chip_smoke.py measures (`arith_step_floor`
// version 2, csrc/devfns_micro.cu: this step's barriers, event slots and
// update on the batch's own symbols, with no symbol coded).
//
// Design: one block a stream and one thread a lane (a launch codes R
// streams of one order through a table of int64 rows; see
// ops/arith_torch.py); threads past N take part in the barriers only; a
// block has max(32, N) threads.
// - The model, in shared memory, is the same for both orders: each context
//   keeps its 256 frequencies as u16, two to a u32 word (128 words; symbol
//   2w in the low half), its 16 group sums (one a group of 16 symbols) two
//   to a word (8 words) and its total. A frequency, a group sum or a total
//   is at most MAX_TOTAL + N * INC = 57,344 at N = 1024, so a half never
//   carries, and every partial sum of a row's halves is at most its total
//   (< 2^16): packed words add exactly, low halves and high halves apart.
//   Order 1 is 256 x (128 + 8) words plus 256 totals and the step's tables,
//   141.6 KB (the decoder adds its 16 KB body ring: 158.0 KB), past the 48
//   KB default: cudaFuncSetAttribute, one block a SM. Rows are swizzled by
//   16-byte slot (slot q of row c at q ^ (c & 7); the group sums' two
//   slots at q ^ ((c >> 2) & 1)), so that lanes in different contexts read
//   different banks. Order 0 is one context: 548 bytes.
// - Lookup (encoder): the two slots of the context's group sums, the two
//   slots of the symbol's group and the total: five independent loads in
//   one round; c = the group sums before the symbol's group plus the
//   frequencies before it in its group, added in registers. Search
//   (decoder): the total and the group sums, then the group (the count of
//   inclusive group prefixes <= v), then the group's two slots, then the
//   symbol within it: two dependent rounds of loads, where PR 12 walked up
//   to 32 dependent 16-byte loads (order 1) or rebuilt order 0's
//   cumulative row by a block scan every step.
// - Renormalisation in each lane, in registers: whether a lane goes
//   depends only on its own low and rng, never on the bytes read, so a lane
//   runs its loop alone and counts its events e. The bound: e <= 3. Proof.
//   Entering a step, rng >= BOT (the loop ended) and the carryless coder
//   keeps low + rng <= 2^32 as integers (true at the start, kept by coding,
//   which gives low + (c + f) r <= low + rng, and by each iteration below).
//   Coding gives rng' = f r >= 2, since r = rng / tot >= 2^16 / 2^15 and
//   f >= 1. An iteration goes on c1, the top bytes of low and low + rng
//   equal, which needs rng < 2^24 while low + rng <= 2^32 (rng > 2^32 -
//   2^24 with low + rng = 2^32 never arises: coding leaves rng <= (1 -
//   255 / tot) of the old one, and an iteration keeps it under 2^24 once
//   low + rng = 2^32), or on c2 alone, rng < BOT. A c1 iteration multiplies
//   rng by 256 and keeps low + rng < 2^32. A c2-only iteration sets rng to
//   the distance from low to the next multiple of 2^16, at most the old rng,
//   so low + rng becomes a multiple of 2^16 and, after the shift, of 2^24:
//   c1 is false from then on, and a second c2-only iteration (rng' < 256)
//   keeps rng and shifts it past BOT. So a step is at most three c1
//   iterations (rng' >= 2 is past 2^24 after three), or at most one c1
//   iteration (after two, rng >= 2^17 is past BOT) and at most two c2-only
//   ones: at most 3 (arith_jax.py:27-32's R_MAX = 8 is safe, and its
//   empirical maximum is 3). A lane that would take a 4th sets an error
//   status (-2), never loops on.
// - Event slots: the format orders a step's events by iteration, then
//   lane, so lane l's i-th event goes to the step's first slot plus the
//   events of iterations before i plus l's rank among the lanes with
//   e > i. Each warp writes its three ballot counts (one u64) before
//   barrier A; after it lane j of every warp reads warp j's, and the warp
//   sums them with __reduce_add_sync (the totals, and the warps before its
//   own).
// - Two barriers a step, three on a step that halves. Barrier A follows
//   every lane's lookup or search and its renorm: it publishes the counts
//   and orders the step's model reads before its updates. The update adds
//   with shared atomics (addition commutes: the batch is deterministic).
//   Order 1: each active lane adds INC to its frequency half, its group-sum
//   half and its context's total; every total is <= MAX_TOTAL after a step,
//   so exactly one add a context crosses MAX_TOTAL when the step takes it
//   over, and its thread lists the context; barrier B is the
//   __syncthreads_or of the crossings. Order 0: each lane adds to its
//   frequency half and its group-sum half, and every thread keeps the one
//   total in a register (it grows by INC x the active lanes, which every
//   thread knows), so barrier B is a plain __syncthreads and no lane waits
//   on an atomic's result. Barrier B orders the updates before the next
//   step's reads and the counts' reuse. On a step that halves, one warp a
//   listed row halves its 128 words and rebuilds its 8 group-sum words and
//   total, then a third barrier. One halving is enough: N * INC + 256 <=
//   MAX_TOTAL for N <= 1024 (arith_jax.py:80, :177; static_assert in
//   arith_model.cuh). Electing one leader a distinct key with
//   __match_any_sync, peeling a warp's commonest keys with shuffles and
//   ballots, or counting order 0's groups with a ballot each, cost more
//   than the atomics they save on this card (PERF.md, PR 13; the floors of
//   csrc/devfns_micro.cu keep the first two).
// - Device memory off the chain: the encoder loads the next step's symbol
//   before the step's barriers and writes each event byte where the format
//   puts it (lane l's b-th emitted byte at 4 l + b for b < 4, else at the
//   slot of its (b - 4)-th event, from a ring of its last four events'
//   ranks: a byte's slot is always an earlier step's, so the writes go out
//   before barrier A). A stream's slot holds 6 + 4 N + 8 n bytes; a write
//   past it is reported (length -1), never made. The decoder reads its event
//   bytes from a 16 KB ring of the body in shared memory, filled ahead with
//   cp.async of 16-byte pieces (a 4 KB chunk a step at most, issued after
//   the step's reads, waited for before the next barrier A, which publishes
//   it); RING >= CHUNK + 6 N and CHUNK >= 3 N keep the next step's at most
//   3 N bytes in the ring. Each read is checked against the body's length:
//   a stream that runs out returns status -1 (as native.arith_decode refuses
//   it), and no copy reads past the body. The decoder keeps its last 16
//   symbols in registers and stores them 16 bytes at a time.
// - Exact u32 division, as the spec (a probe that drops it saves under 3%
//   of an encoder step).
// - No indexed register array: a dynamic index puts an array in local
//   memory, so a half's value is a difference of two prefixes and the
//   ring of ranks is four named registers. Blocks of at most 256 threads
//   (the codecs' lane counts) take a build bounded for 256 threads, so
//   that it may hold more registers than the 1024-thread one.

#include <cstdint>
#include <cuda_runtime.h>

#include "arith_model.cuh"

namespace {

using namespace arithk;

constexpr int RING = 16384;     // the decoder's body ring
constexpr int CHUNK = 4096;     // bytes a refill, at most one a step
constexpr int BOUND_BROKEN = -2;
static_assert(RING >= CHUNK + 6 * MAX_THREADS && CHUNK >= 3 * MAX_THREADS,
              "the ring holds a step's bytes ahead");

template <int ORDER>
__host__ __device__ constexpr size_t ring_off() {
  return (sizeof(Smem<ORDER>) + 15) & ~(size_t)15;
}

// the ranks of a lane's last four events, in registers: event j's at j & 3
struct Ranks4 {
  int64_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;

  __device__ __forceinline__ int64_t get(uint32_t j) const {
    j &= 3;
    return j == 0 ? r0 : j == 1 ? r1 : j == 2 ? r2 : r3;
  }
  __device__ __forceinline__ void set(uint32_t j, int64_t v) {
    j &= 3;
    r0 = j == 0 ? v : r0;
    r1 = j == 1 ? v : r1;
    r2 = j == 2 ? v : r2;
    r3 = j == 3 ? v : r3;
  }
};

// lane l's b-th byte: 4 l + b for b < 4, else the slot of its (b-4)-th event
__device__ __forceinline__ void put(uint8_t* body, int64_t cap, int N, int l,
                                    uint32_t b, const Ranks4& ranks,
                                    uint8_t byte, bool& overflow) {
  const int64_t pos = b < 4 ? 4 * (int64_t)l + b
                            : 4 * (int64_t)N + ranks.get(b);
  if (pos < cap) body[pos] = byte;
  else overflow = true;
}

template <int ORDER, int MAXT>
__global__ void __launch_bounds__(MAXT)
arith_encode_kernel(const uint8_t* __restrict__ data,
                    const int64_t* __restrict__ meta,
                    uint8_t* __restrict__ out, int64_t* __restrict__ lens) {
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
  const ActiveLanes lanes(n, K, N);
  uint32_t low = 0, rng = 0xffffffffu, prev = 0, nev = 0, tot0 = 256;
  uint32_t cur = lane_len > 0 ? __ldg(src) : 0;
  int64_t ev = 0;                 // events so far, the same in every thread
  Ranks4 ranks;
  bool overflow = false, over = false;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    const uint32_t sym = cur;
    cur = s + 1 < lane_len ? __ldg(src + s + 1) : 0;
    const uint32_t ctx = ORDER ? prev : 0;
    if (act) {
      uint32_t f, c, tot;
      lookup(sm, ctx, sym, tot0, f, c, tot);
      const uint32_t r = rng / tot;
      low += c * r;
      rng = f * r;
    }
    uint32_t bytes;
    const uint32_t e = renorm(act, low, rng, &bytes, &over);
#pragma unroll
    for (uint32_t i = 0; i < MAX_EVENTS; i++)
      if (i < e)
        put(body, body_cap, N, t, nev + i, ranks, (uint8_t)(bytes >> (8 * i)),
            overflow);
    publish_counts(sm.cnt, e);
    __syncthreads();                                   // barrier A
    uint32_t slot[MAX_EVENTS];
    const uint32_t step_ev = event_slots(sm.cnt, e, slot);
#pragma unroll
    for (uint32_t i = 0; i < MAX_EVENTS; i++)
      if (i < e) ranks.set(nev + i, ev + slot[i]);
    nev += e;
    ev += step_ev;
    model_update(sm, act, ctx, sym, tot0, lanes.at(s));  // barrier B
    prev = sym;
  }
  if (t < N) {
#pragma unroll
    for (uint32_t k = 0; k < 4; k++) {
      put(body, body_cap, N, t, nev + k, ranks, (uint8_t)(low >> 24),
          overflow);
      low <<= 8;
    }
  }
  overflow = __syncthreads_or(overflow);
  over = __syncthreads_or(over);
  if (t == 0) {
    uint8_t* h = out + out_off;
    h[0] = (uint8_t)m[4];
    h[1] = (uint8_t)ORDER;
    for (int k = 0; k < 4; k++) h[2 + k] = (uint8_t)((uint64_t)n >> (8 * k));
    lens[blockIdx.x] = over ? BOUND_BROKEN : overflow ? -1
                            : HEADER + 4 * (int64_t)N + ev;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint32_t nbytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(nbytes)
               : "memory");
}

// The decoder's body in a ring of RING bytes: body byte x at ring
// position (x + delta) mod RING, delta the body's offset in its aligned
// 16-byte piece, so whole aligned pieces are copied. fill(p0, p1) copies
// the pieces [p0, p1) (ring coordinates, multiples of 16) with cp.async,
// each thread some of them; the bytes past the body are zero-filled, never
// read, and the piece holding the body's first byte is read byte by byte
// from that byte on when the body is not aligned.
struct BodyRing {
  uint8_t* ring;
  const uint8_t* base;      // the body's aligned piece
  int64_t delta, end;       // the body's first and last + 1 ring coordinate

  __device__ void fill(int64_t p0, int64_t p1) const {
    for (int64_t p = p0 + 16 * (int64_t)threadIdx.x; p < p1;
         p += 16 * (int64_t)blockDim.x) {
      uint8_t* dst = ring + (p & (RING - 1));
      if (p < delta) {                  // the body's first, unaligned piece
        for (int64_t q = delta; q < 16 && q < end; q++) dst[q] = base[q];
        continue;
      }
      const int64_t left = end - p;
      cp_async16(dst, base + p, (uint32_t)(left < 16 ? left : 16));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// the 16 symbols a lane keeps in registers (oldest in the low byte of w0)
// out to dst: m <= 16 of them, the m latest
__device__ __forceinline__ void store_syms(uint8_t* dst, uint32_t (&w)[4],
                                           int m) {
  for (int k = m; k < 16; k++) {        // the m symbols down to byte 0
    w[0] = __funnelshift_r(w[0], w[1], 8);
    w[1] = __funnelshift_r(w[1], w[2], 8);
    w[2] = __funnelshift_r(w[2], w[3], 8);
    w[3] >>= 8;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (m == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (m == 16 && (a & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 4; j++) reinterpret_cast<uint32_t*>(dst)[j] = w[j];
  } else {
#pragma unroll
    for (int j = 0; j < 16; j++)
      if (j < m) dst[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
  }
}

template <int ORDER, int MAXT>
__global__ void __launch_bounds__(MAXT)
arith_decode_kernel(const uint8_t* __restrict__ bufs,
                    const int64_t* __restrict__ meta,
                    uint8_t* __restrict__ out, int64_t* __restrict__ status) {
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
  if (t < N) {   // the host checked blen >= 4 N
    lane_len = n - (int64_t)t * K;
    lane_len = lane_len < 0 ? 0 : lane_len > K ? K : lane_len;
    code = ((uint32_t)body[4 * t] << 24) | ((uint32_t)body[4 * t + 1] << 16) |
           ((uint32_t)body[4 * t + 2] << 8) | body[4 * t + 3];
  }
  BodyRing br;
  br.ring = smem_raw + ring_off<ORDER>();
  br.delta = (int64_t)(reinterpret_cast<uintptr_t>(body) & 15);
  br.base = body - br.delta;
  br.end = br.delta + blen;
  const int64_t end16 = (br.end + 15) & ~(int64_t)15;
  int64_t filled = end16 < RING ? end16 : RING;   // ring coordinates
  br.fill(0, filled);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  uint8_t* dst = out + out_off + (int64_t)t * K;
  model_init(sm);                       // its barrier publishes the ring
  const ActiveLanes lanes(n, K, N);
  uint32_t low = 0, rng = 0xffffffffu, prev = 0, tot0 = 256;
  uint32_t sw[4] = {0, 0, 0, 0};
  int64_t ptr = 4 * (int64_t)N;   // the same in every thread
  bool bad = false, over = false;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    const uint32_t ctx = ORDER ? prev : 0;
    uint32_t sym = 0;
    if (act) {
      uint32_t gs[8];
      load_gsums(sm, ctx, gs);
      const uint32_t tot = ORDER ? sm.total[ctx] : tot0;
      const uint32_t r = rng / tot;
      uint32_t v = (code - low) / (r ? r : 1);
      v = v < tot - 1 ? v : tot - 1;
      uint32_t f, c;
      sym = search(sm, ctx, gs, v, f, c);
      low += c * r;
      rng = f * r;
      sw[0] = __funnelshift_r(sw[0], sw[1], 8);
      sw[1] = __funnelshift_r(sw[1], sw[2], 8);
      sw[2] = __funnelshift_r(sw[2], sw[3], 8);
      sw[3] = (sw[3] >> 8) | (sym << 24);
      if ((s & 15) == 15 || s + 1 == lane_len)
        store_syms(dst + (s & ~(int64_t)15), sw, (int)(s & 15) + 1);
    }
    uint32_t unused;
    const uint32_t e = renorm(act, low, rng, &unused, &over);
    publish_counts(sm.cnt, e);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                                   // barrier A
    uint32_t slot[MAX_EVENTS];
    const uint32_t step_ev = event_slots(sm.cnt, e, slot);
#pragma unroll
    for (uint32_t i = 0; i < MAX_EVENTS; i++) {
      if (i >= e) break;
      const int64_t pos = ptr + slot[i];
      uint32_t byte = 0;
      if (pos < blen) byte = br.ring[(pos + br.delta) & (RING - 1)];
      else bad = true;
      code = (code << 8) | byte;
    }
    // refill the chunk ahead once the bytes below this step's are free
    if (filled < end16 && filled + CHUNK <= ptr + br.delta + RING) {
      const int64_t to = filled + CHUNK < end16 ? filled + CHUNK : end16;
      br.fill(filled, to);
      filled = to;
    }
    ptr += step_ev;
    model_update(sm, act, ctx, sym, tot0, lanes.at(s));  // barrier B
    prev = sym;
  }
  bad = __syncthreads_or(bad);
  over = __syncthreads_or(over);
  if (t == 0) status[blockIdx.x] = over ? BOUND_BROKEN : bad ? -1 : n;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const void* in, const void* meta,
           int R, int threads, void* out, void* res, void* stream) {
  if (R <= 0) return 0;
  if (threads < MIN_THREADS || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
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

// a block of at most SMALL threads (N <= 256, the lane counts the codecs
// choose) takes the build that may hold up to 255 registers a thread
constexpr int SMALL = 256;

template <int ORDER>
int encode(const void* data, const void* meta, int R, int threads, void* out,
           void* lens, void* stream) {
  return threads <= SMALL
      ? launch(arith_encode_kernel<ORDER, SMALL>, sizeof(Smem<ORDER>), data,
               meta, R, threads, out, lens, stream)
      : launch(arith_encode_kernel<ORDER, MAX_THREADS>, sizeof(Smem<ORDER>),
               data, meta, R, threads, out, lens, stream);
}

template <int ORDER>
int decode(const void* bufs, const void* meta, int R, int threads, void* out,
           void* status, void* stream) {
  const size_t smem = ring_off<ORDER>() + RING;
  return threads <= SMALL
      ? launch(arith_decode_kernel<ORDER, SMALL>, smem, bufs, meta, R,
               threads, out, status, stream)
      : launch(arith_decode_kernel<ORDER, MAX_THREADS>, smem, bufs, meta, R,
               threads, out, status, stream);
}

}  // namespace

extern "C" {

// R streams of one order: data holds their symbols, meta R rows of (offset
// of the symbols, n, offset of the stream's slot in out, the slot's bytes,
// log2 N, 0); lens[r] gets the stream's length, header included, -1 if its
// slot overflowed, or -2 if a lane broke the renorm bound. threads: a
// multiple of 32 in [32, 1024], at least every stream's N. Returns the CUDA
// error of the launch.
int arith_encode(int order, const void* data, const void* meta, int R,
                 int threads, void* out, void* lens, void* stream) {
  return order ? encode<1>(data, meta, R, threads, out, lens, stream)
               : encode<0>(data, meta, R, threads, out, lens, stream);
}

// R streams of one order: bufs holds them, meta R rows of (offset of the
// stream's body, the body's bytes (>= 4 N), offset of its symbols in out, n,
// log2 N, 0); status[r] gets n, -1 if the body ran out of bytes, or -2 if a
// lane broke the renorm bound.
int arith_decode(int order, const void* bufs, const void* meta, int R,
                 int threads, void* out, void* status, void* stream) {
  return order ? decode<1>(bufs, meta, R, threads, out, status, stream)
               : decode<0>(bufs, meta, R, threads, out, status, stream);
}

}  // extern "C"

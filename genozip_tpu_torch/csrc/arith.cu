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
// What bounds it: neither bytes (n in, about n out) nor operations (about
// 20 integer operations a symbol that the function needs; this kernel
// spends more, on its block scans and its order-1 row walk), but the chain
// of K = n / N steps, each a few block-wide barriers that no lane can run
// ahead of: the model a step reads is the one every lane's previous symbol
// updated. chip_smoke.py measures that chain's floor
// (`arith_step_floor`, csrc/devfns_micro.cu).
//
// Design: one block a stream and one thread a lane (a launch codes R
// streams of one order through a table of int64 rows; see
// ops/arith_torch.py); threads past N take part in the barriers only, and
// a block has at least 256 threads, one a symbol of the model.
// - The model lives in shared memory as u16 frequencies, two to a u32
//   word (symbol 2w in the low half, 2w + 1 in the high half). A frequency
//   is at most MAX_TOTAL + N * INC = 57,344 at N = 1024, so a half never
//   carries, and the update is one shared atomicAdd of INC << 16 (s & 1) a
//   lane; addition commutes, so the batch is deterministic. Every partial
//   sum of a row's frequencies is at most its total (< 2^16), so the u32
//   sum of packed words is two exact u16 sums, and a row walk adds whole
//   words. Order 1 is 256 x 128 words (128 KiB) plus 256 totals, past the
//   48 KiB default: cudaFuncSetAttribute gives the block 133.5 KB of
//   dynamic shared memory, one block a SM. Its rows are swizzled by 16-byte
//   slot (slot q of row c at q ^ (c & 7)), so that lanes walking different
//   contexts read different banks.
// - Cumulative frequencies: order 0 keeps the exclusive cumulative row and
//   the total (257 words), rebuilt by a block scan of 256 threads after
//   each update; the encoder reads c there, the decoder binary-searches it
//   (8 probes). Order 1 walks the lane's context row with 16-byte loads,
//   8 symbols a load (up to 32 loads); a Fenwick tree a context is the
//   later, faster form.
// - Halving: after the update's barrier, threads 0-255 each test one
//   context's total (order 0: the scan's); while any is over, the over
//   contexts are listed by a block rank and each warp halves whole rows
//   (4 words a lane) and sums them by a warp reduction.
// - Renormalisation: each iteration takes a block-wide exclusive rank of
//   `go` (__ballot_sync and __popc in the warp, the warps' counts in shared
//   memory) and loops on __syncthreads_or(go); the counts are double
//   buffered, so the __syncthreads_or is the iteration's only barrier.
// - The encoder writes the decoder's byte order itself: lane l's b-th
//   emitted byte goes to 4 l + b if b < 4, else to the slot of the lane's
//   (b - 4)-th event, 4 N + its global rank; each lane keeps the ranks of
//   its last four events in a ring, and the four flush bytes follow the
//   same rule. A stream's slot holds 6 + 4 N + 8 n bytes; a write past it
//   is reported (length -1), never made.
// - The decoder reads event bytes at ptr + rank and checks each read
//   against the stream's length: a stream that runs out returns status -1
//   (as native.arith_decode refuses it), never reads past its buffer.
// - Exact u32 division, as the spec.

#include <cstdint>
#include <cuda_runtime.h>

#include "arith_model.cuh"

namespace {

using namespace arithk;

// (f, exclusive cum, total) of `sym` in context `ctx`
template <int ORDER>
__device__ __forceinline__ void lookup(const Smem<ORDER>& sm, uint32_t ctx,
                                       uint32_t sym, uint32_t& f,
                                       uint32_t& c, uint32_t& tot) {
  if (!ORDER) {
    f = half_of(sm.words[sym >> 1], sym);
    c = sm.aux[sym];
    tot = sm.aux[256];
    return;
  }
  const uint4* row = reinterpret_cast<const uint4*>(sm.words + ctx * 128);
  const uint32_t sw = ctx & 7, qs = sym >> 3, wi = (sym >> 1) & 3;
  uint32_t acc = 0;
  for (uint32_t q = 0; q < qs; q++) {
    const uint4 v = row[q ^ sw];
    acc += v.x + v.y + v.z + v.w;
  }
  const uint4 v = row[qs ^ sw];
  acc += (wi > 0 ? v.x : 0) + (wi > 1 ? v.y : 0) + (wi > 2 ? v.z : 0);
  const uint32_t word = wi == 0 ? v.x : wi == 1 ? v.y : wi == 2 ? v.z : v.w;
  if (sym & 1) acc += word & 0xffffu;
  f = half_of(word, sym);
  c = (acc & 0xffffu) + (acc >> 16);
  tot = sm.aux[ctx];
}

// the decoder's symbol: the number of inclusive cums <= v, at most 255,
// with its f and exclusive cum
template <int ORDER>
__device__ __forceinline__ uint32_t search(const Smem<ORDER>& sm,
                                           uint32_t ctx, uint32_t v,
                                           uint32_t& f, uint32_t& c) {
  if (!ORDER) {
    uint32_t s = 0;
#pragma unroll
    for (uint32_t step = 128; step; step >>= 1)
      if (sm.aux[s + step] <= v) s += step;
    f = half_of(sm.words[s >> 1], s);
    c = sm.aux[s];
    return s;
  }
  const uint4* row = reinterpret_cast<const uint4*>(sm.words + ctx * 128);
  const uint32_t sw = ctx & 7;
  uint32_t acc = 0, q = 0;
  uint4 x;
  for (;; q++) {
    x = row[q ^ sw];
    if (q == 31) break;
    const uint32_t s = x.x + x.y + x.z + x.w;
    const uint32_t sum = (s & 0xffffu) + (s >> 16);
    if (acc + sum > v) break;
    acc += sum;
  }
  const uint32_t ws[4] = {x.x, x.y, x.z, x.w};
  uint32_t sym = q * 8 + 7;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint32_t fk = half_of(ws[k >> 1], k);
    if (acc + fk > v || k == 7) {
      sym = q * 8 + k;
      f = fk;
      break;
    }
    acc += fk;
  }
  c = acc;
  return sym;
}

__device__ __forceinline__ int64_t ring_get(const int64_t (&r)[4],
                                            uint32_t i) {
  i &= 3;
  return i == 0 ? r[0] : i == 1 ? r[1] : i == 2 ? r[2] : r[3];
}

__device__ __forceinline__ void ring_set(int64_t (&r)[4], uint32_t i,
                                         int64_t v) {
  i &= 3;
  if (i == 0) r[0] = v;
  else if (i == 1) r[1] = v;
  else if (i == 2) r[2] = v;
  else r[3] = v;
}

// lane l's b-th byte: 4 l + b for b < 4, else the slot of its (b-4)-th event
__device__ __forceinline__ void put(uint8_t* body, int64_t cap, int N, int l,
                                    uint32_t b, const int64_t (&ring)[4],
                                    uint8_t byte, bool& overflow) {
  const int64_t pos = b < 4 ? 4 * (int64_t)l + b
                            : 4 * (int64_t)N + ring_get(ring, b);
  if (pos < cap) body[pos] = byte;
  else overflow = true;
}

template <int ORDER>
__global__ void __launch_bounds__(MAX_THREADS)
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
  uint32_t low = 0, rng = 0xffffffffu, prev = 0, nev = 0;
  int64_t ev = 0;                 // events so far, the same in every thread
  int64_t ring[4] = {0, 0, 0, 0};
  bool overflow = false;
  int parity = 0;
  for (int64_t s = 0; s < K; s++) {
    const bool act = s < lane_len;
    const uint32_t sym = act ? src[s] : 0;
    const uint32_t ctx = ORDER ? prev : 0;
    if (act) {
      uint32_t f, c, tot;
      lookup(sm, ctx, sym, f, c, tot);
      const uint32_t r = rng / tot;
      low += c * r;
      rng = f * r;
    }
    for (;;) {
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
        put(body, body_cap, N, t, nev, ring, (uint8_t)(low >> 24), overflow);
        ring_set(ring, nev, ev + rk);
        nev++;
        low <<= 8;
        rng <<= 8;
      }
      ev += cnt;
    }
    model_update(sm, act, ctx, sym);
    prev = sym;
  }
  if (t < N) {
#pragma unroll
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
    lens[blockIdx.x] = overflow ? -1 : HEADER + 4 * (int64_t)N + ev;
  }
}

template <int ORDER>
__global__ void __launch_bounds__(MAX_THREADS)
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
  uint8_t* dst = out + out_off + (int64_t)t * K;
  model_init(sm);
  uint32_t low = 0, rng = 0xffffffffu, prev = 0;
  int64_t ptr = 4 * (int64_t)N;   // the same in every thread
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
      sym = search(sm, ctx, v, f, c);
      low += c * r;
      rng = f * r;
      dst[s] = (uint8_t)sym;
    }
    for (;;) {
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
        const int64_t pos = ptr + rk;
        uint32_t byte = 0;
        if (pos < blen) byte = body[pos];
        else bad = true;
        code = (code << 8) | byte;
        low <<= 8;
        rng <<= 8;
      }
      ptr += cnt;
    }
    model_update(sm, act, ctx, sym);
    prev = sym;
  }
  bad = __syncthreads_or(bad);
  if (t == 0) status[blockIdx.x] = bad ? -1 : n;
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

}  // namespace

extern "C" {

// R streams of one order: data holds their symbols, meta R rows of (offset
// of the symbols, n, offset of the stream's slot in out, the slot's bytes,
// log2 N, 0); lens[r] gets the stream's length, header included, or -1 if
// its slot overflowed. threads: a multiple of 32 in [256, 1024], at least
// every stream's N. Returns the CUDA error of the launch.
int arith_encode(int order, const void* data, const void* meta, int R,
                 int threads, void* out, void* lens, void* stream) {
  return order ? launch(arith_encode_kernel<1>, sizeof(Smem<1>), data, meta,
                        R, threads, out, lens, stream)
               : launch(arith_encode_kernel<0>, sizeof(Smem<0>), data, meta,
                        R, threads, out, lens, stream);
}

// R streams of one order: bufs holds them, meta R rows of (offset of the
// stream's body, the body's bytes (>= 4 N), offset of its symbols in out, n,
// log2 N, 0); status[r] gets n, or -1 if the body ran out of bytes.
int arith_decode(int order, const void* bufs, const void* meta, int R,
                 int threads, void* out, void* status, void* stream) {
  return order ? launch(arith_decode_kernel<1>, sizeof(Smem<1>), bufs, meta,
                        R, threads, out, status, stream)
               : launch(arith_decode_kernel<0>, sizeof(Smem<0>), bufs, meta,
                        R, threads, out, status, stream);
}

}  // extern "C"

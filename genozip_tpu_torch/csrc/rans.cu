// RANS-W32x16 entropy coder: four hand-written Hopper kernels (sm_90a).
//
// The stream format is normative in genozip_tpu_torch/ops/rans_np.py (a copy
// of genozip_tpu/ops/rans_np.py): N interleaved lanes (lane l codes the
// symbol chunk [l*K, min((l+1)*K, n))), a 32-bit state in [2^16, 2^32), a
// 12-bit scale, at most one u16 renorm word per symbol, and one shared word
// stream in (step, lane) order. Each kernel's output is byte-identical to
// rans_np's (the host frames header and states).
//
// What the entry points replace (genozip_tpu/ops/rans_pallas.py):
//   rans_encode_o0  <- K1 _encode_many_kernel_v6 (encode_many_v6), and
//                      _encode_many_kernel (encode_many) and _encode_kernel
//                      (encode) at a fixed lane count
//   rans_decode_o0  <- K2 _decode_many_kernel_v6 (decode_many_v6), K7
//                      _decode_many_kernel (decode_many) and decode's kernels
//   rans_encode_o1  <- K3 _encode_many_kernel_o1v6 (encode_many_o1_v6), K5
//                      _encode_many_o1_kernel (encode_many_o1) and
//                      _encode_kernel_o1 (encode_order1)
//   rans_decode_o1  <- K4 _decode_many_kernel_o1v6 (decode_many_o1_v6), K6
//                      _decode_many_o1_kernel (decode_many_o1) and
//                      _decode_kernel_o1 (decode_order1)
//
// The TPU workarounds (float limb division, one-hot matmul lookups, lane-roll
// scans, padded word blocks) have no place here.
//
// The encoders (rows 1, 3, 5, 8, 9 and 16 of the TPU kernel table: K1, K3,
// K5 and the pre-v6 and single-stream encoders) are lane-parallel. A lane's
// arithmetic reads only its own state and symbols: the emit test x >= f<<20,
// the word x & 0xffff and x' = (x/f << 12) + x%f + c. The word pointer only
// decides where the words land, so no step of one lane waits for another
// lane. One encode is five or six launches on the caller's stream:
//   * o1_enc_entries_kernel (order 1): a packed entry per (ctx, sym), with f,
//     c and a Granlund-Montgomery reciprocal, so x/f is one umulhi and
//     shifts (rans_common.cuh); order 0 builds its 256 in shared memory;
//   * stripe_kernel: each stream's symbols as rows of 8-step words, lane
//     l's steps 8b .. 8b+7 at (b, l), so a thread reads 8 steps' symbols
//     with one 8-byte load and a warp 256 contiguous bytes;
//   * encode_lanes_kernel: one thread per lane, a stream's lanes spread over
//     blocks of 128 (R = 1 at N = 8192 fills 64 SMs), the state in a
//     register for all K steps; it stores each lane's words of 8 steps in
//     one 16-byte store to scratch and one ballot mask per warp and step,
//     with no barrier;
//   * scan_sums_kernel and scan_partials_kernel: an exclusive scan, per
//     stream, of the masks' popcounts in the decoder's order (step, then
//     lane), two-level so that a 134 MB stream's 4M masks spread over
//     blocks; the total S gives the first word out_len - S;
//   * scatter_kernel: each emitted word to its place.
// What bounds them: a lane's chain of K steps (the emit compare, one umulhi,
// shifts and a multiply-add a step: about 55 cycles on an H100, the chain
// floor of chip_smoke.py phase 2b), and past that the bytes of the stripe,
// the scratch and the scatter.
//
// The decoders are a serial chain: a lane's next renorm word lands at a
// position ranked over every lane of the step, and the next step's word
// pointer depends on how many lanes emitted. So a stream is a chain of K =
// n/N steps, each a block-wide scan, and the time is K times the latency of
// one step. One block of 1024 threads per stream and one launch for R
// streams, so R chains run side by side on R SMs, each thread on J = N/1024
// consecutive lanes with their states in registers, ranked by a per-thread
// count and two shuffle scans (block_rank_runs, rans_common.cuh), two
// barriers a step. They keep device memory off a step's critical path:
//   * one lookup per symbol: a packed u32 slot entry, symbol | (f-1) << 8 |
//     (slot-cum) << 20, so x' = f * (x >> 12) + (slot - cum) needs no second
//     table. Order 0 builds its 4096 entries in shared memory in the prologue
//     from the (freq, cum) table; order 1 has 256 contexts x 4096 slots (4 MB
//     a stream), built in device memory by o1_slots_kernel just before the
//     decoder and read through L1 and L2 (one dependent load a step). The
//     decoders take little shared memory (80 KB, 64 KB), so L1 keeps most of
//     the SM's 256 KB for those entries.
//   * the renorm words come from a ring of 4N u16 words in shared memory,
//     filled ahead of the consumer by cp.async of whole 16-byte chunks
//     (WordRing in rans_common.cuh): step s issues the words up to p_s + 3N
//     and waits for the copies of step s-2.
//   * the symbols are written in the format's own (step, lane) order, one
//     row of N bytes a step, so 32 lanes fill one 32-byte sector, into a
//     scratch buffer; unstripe_kernel, on every SM, then writes each lane's
//     chunk out through 32 x 32 tiles. Writing straight to lane l's chunk
//     l*K + t costs a sector per lane per step; staging T steps in a shared-
//     memory tile before writing the chunks still left 32/T lanes per warp
//     store at T = 8 (rans_micro.cu keeps that version, PERF.md the times).
// The ring refill runs between the step's two barriers, while warp 0 scans.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute); the Python
// wrapper raises when it is not 0.

#include <algorithm>

#include "rans_common.cuh"

namespace {

using namespace rans;

constexpr int MAX_LANES = NT * JMAX;           // 8192
constexpr int SCAN_BYTES = (2 * NW + 4) * 4;
constexpr int O0_ENT_BYTES = ((1 << SCALE_BITS) + 512) * 4;   // + build scratch

// dynamic shared memory of the decoders: the word ring, the scan buffers
// and (order 0) the slot entries; the rest of the SM's 256 KB is L1, which
// caches the order-1 slot entries
template <int ORDER>
__host__ __device__ constexpr int dec_smem() {
  return WordRing::BYTES + SCAN_BYTES + (ORDER == 0 ? O0_ENT_BYTES : 0);
}

// Stream r's rows in the decoders' scratch: 16-byte aligned, K*N < n + N
// bytes each, so that [rows_off, rows_off + K*N) stay apart across streams.
constexpr int64_t ROW_PAD = MAX_LANES + 16;
__device__ __forceinline__ int64_t rows_off(const int64_t* m, int r) {
  return (m[5] + (int64_t)r * ROW_PAD + 15) & ~(int64_t)15;
}

// Decode meta row: word_off, nwords, n, N, K, out_off, 0, 0. words holds each
// stream's body: 2N state words (hi, lo per lane), then the renorm words.
// tab as for encode; slots: order-1 slot entries (o1_slots_kernel), unused by
// order 0. rows: each stream's symbols in the format's (step, lane) order, K
// rows of N bytes at rows_off (unstripe_kernel turns them into the n output
// bytes). Thread tid owns the J = N/1024 consecutive lanes tid*J + j (one
// lane, tid < N, for N <= 1024), so a step's J symbols go out in one store
// and its J renorm words sit side by side in the ring.
template <int ORDER>
__global__ void __launch_bounds__(NT)
rans_decode_kernel(const uint16_t* __restrict__ words,
                   const int64_t* __restrict__ meta,
                   const int32_t* __restrict__ tab,
                   const uint32_t* __restrict__ slots,
                   uint8_t* __restrict__ rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* cnt = (uint32_t*)(smem + WordRing::BYTES);    // 2 * NW
  uint32_t* tot = cnt + 2 * NW;                           // 2 (+2 spare)
  uint32_t* s_ent = (uint32_t*)(smem + WordRing::BYTES + SCAN_BYTES);

  const int r = blockIdx.x, tid = threadIdx.x;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t nwords = m[1], n = m[2], N = m[3], K = m[4];
  const uint16_t* w = words + m[0];
  const int J = (int)((N + NT - 1) / NT);
  const int l0 = tid * J;         // this thread's first lane
  uint8_t* row = rows + rows_off(m, r) + l0;
  const uint32_t* sl = slots + ((int64_t)r << 20);        // order 1

  if (ORDER == 0) {
    uint32_t* s_f = s_ent + (1 << SCALE_BITS);            // scratch
    uint32_t* s_c = s_f + 256;
    const int32_t* t0 = tab + (int64_t)r * 512;
    for (int i = tid; i < 256; i += NT) {
      s_f[i] = (uint32_t)t0[i];
      s_c[i] = (uint32_t)t0[256 + i];
    }
    __syncthreads();
    for (int slot = tid; slot < (1 << SCALE_BITS); slot += NT)
      s_ent[slot] = slot_entry(s_f, s_c, slot);
  }

  uint32_t x[JMAX], ctx[JMAX / 4];  // order 1: lane j's context in byte j%4
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int l = l0 + j;
    x[j] = 0;
    if (j < J && l < N && 2 * l + 1 < nwords)
      x[j] = ((uint32_t)w[2 * l] << 16) | w[2 * l + 1];
  }
#pragma unroll
  for (int k = 0; k < JMAX / 4; ++k) ctx[k] = 0;
  // lanes below lf hold K symbols, lane lf holds rem (< K), the rest none
  const int lf = K ? (int)(n / K) : 0;
  const int64_t rem = K ? n % K : 0;

  WordRing ring;
  ring.init(smem, w, nwords, N);
  int64_t p = 2 * N;
  ring.refill(p, tid, NT);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int64_t t = 0; t < K; ++t, row += N) {
    const bool tail = t < rem;
    uint32_t need = 0, sy[2] = {0u, 0u};   // the J symbols, packed
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int l = l0 + j;
      if (j < J && (l < lf || (l == lf && tail))) {
        const uint32_t slot = x[j] & SLOT_MASK;
        uint32_t e;
        if (ORDER == 0) {
          e = s_ent[slot];
        } else {
          const uint32_t c = (ctx[j / 4] >> (8 * (j % 4))) & 0xffu;
          e = __ldg(sl + ((c << SCALE_BITS) | slot));
          ctx[j / 4] = (ctx[j / 4] & ~(0xffu << (8 * (j % 4)))) |
                       ((e & 0xffu) << (8 * (j % 4)));
        }
        x[j] = (((e >> 8) & 0xfffu) + 1u) * (x[j] >> SCALE_BITS) + (e >> 20);
        sy[j / 4] |= (e & 0xffu) << (8 * (j % 4));
        if (x[j] < RANS_L) need |= 1u << j;
      }
    }
    // lanes past n get 0 bytes here, which unstripe_kernel never reads
    if (J == 8) {
      *(uint2*)row = make_uint2(sy[0], sy[1]);
    } else if (J == 4) {
      *(uint32_t*)row = sy[0];
    } else if (J == 2) {
      *(uint16_t*)row = (uint16_t)sy[0];
    } else if (tid < N) {
      *row = (uint8_t)sy[0];
    }
    uint32_t first;
    const uint32_t S = block_rank_runs(need, (int)(t & 1), cnt, tot, first, [&] {
      if (tid >= 32) {            // warps 1-31 copy while warp 0 scans
        ring.refill(p, tid - 32, NT - 32);
        cp_async_commit();
        cp_async_wait<2>();       // the copies of step t-2 have landed
      }
    });
    const int64_t q = p + first;
#pragma unroll
    for (int j = 0; j < JMAX; ++j)
      if ((need >> j) & 1u)
        x[j] = (x[j] << 16) | ring.word(q + __popc(need & ((1u << j) - 1u)));
    p += S;
  }
}

// Rows of R streams -> their output: out[l*K + t] = rows[t*N + l] for
// l*K + t < n, through 32 x 32 tiles in shared memory so that both the row
// reads and the output writes cover whole 32-byte sectors.
__global__ void __launch_bounds__(256)
unstripe_kernel(const int64_t* __restrict__ meta,
                const uint8_t* __restrict__ rows, uint8_t* __restrict__ out) {
  __shared__ uint8_t tile[32][33];
  const int r = blockIdx.y;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t n = m[2], N = m[3], K = m[4];
  const uint8_t* rw = rows + rows_off(m, r);
  uint8_t* o = out + m[5];
  const int64_t nl = (N + 31) / 32, tiles = nl * ((K + 31) / 32);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int64_t b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int64_t l0 = (b % nl) * 32, t0 = (b / nl) * 32;
    for (int i = ty; i < 32; i += 8) {           // i: step, tx: lane
      const int64_t t = t0 + i, l = l0 + tx;
      tile[i][tx] = t < K && l < N ? rw[t * N + l] : 0;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {           // i: lane, tx: step
      const int64_t l = l0 + i, t = t0 + tx, g = l * K + t;
      if (l < N && t < K && g < n) o[g] = tile[tx][i];
    }
    __syncthreads();
  }
}

constexpr int UNSTRIPE_BLOCKS = 1024;   // per launch, shared by the streams

// work: order 1: R x 4 MB of slot entries, then the rows (n_out + R * ROW_PAD
// bytes); order 0: the rows.
template <int ORDER>
int launch_decode(const void* words, const void* meta, const void* tab,
                  void* work, void* out, int R, cudaStream_t stream) {
  const int smem = dec_smem<ORDER>();
  cudaError_t e = cudaFuncSetAttribute(
      rans_decode_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  uint32_t* slots = (uint32_t*)work;
  uint8_t* rows = (uint8_t*)work + (ORDER == 1 ? ((size_t)R << 22) : 0);
  if (ORDER == 1) {
    o1_slots_kernel<<<dim3(256, R), 256, 0, stream>>>((const int32_t*)tab,
                                                      slots);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rans_decode_kernel<ORDER><<<R, NT, smem, stream>>>(
      (const uint16_t*)words, (const int64_t*)meta, (const int32_t*)tab,
      slots, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int gx = (UNSTRIPE_BLOCKS + R - 1) / R;
  unstripe_kernel<<<dim3(gx, R), 256, 0, stream>>>((const int64_t*)meta, rows,
                                                   (uint8_t*)out);
  return (int)cudaGetLastError();
}

// ---- the encoders' word placement ------------------------------------------

// A stream's emit masks: K steps x ceil(N/32) warps, in the decoder's order;
// its scan chunks: the masks of 8 steps (one block of pass 1's words)
__device__ __forceinline__ int64_t n_masks(const int64_t* m) {
  return m[3] * ((m[2] + 31) >> 5);
}
__device__ __forceinline__ int64_t n_chunks(const int64_t* m) {
  return (m[3] + SB - 1) / SB;
}

// Inclusive sum over the block's threads (NTH a multiple of 32, at most
// 1024) of v; `ws` holds NTH/32 words. Returns the inclusive prefix and in
// `total` the block's sum. Ends with a barrier, so `ws` may be used again.
template <int NTH>
__device__ __forceinline__ uint32_t block_inclusive(uint32_t v, uint32_t* ws,
                                                    uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NTH / 32; ++w) {
    const uint32_t s = ws[w];
    before += w < warp ? s : 0u;
    all += s;
  }
  __syncthreads();
  total = all;
  return before + inc;
}

constexpr int SCAN_T = 256;                // threads of scan_sums_kernel
constexpr int SCATTER_T = 1024;            // threads (lanes) of scatter_kernel
constexpr int CH_MAX = SB * MAX_LANES / 32;  // masks a chunk holds, at most

// The exclusive popcount prefix of the chunk's nm masks from mask i0, from
// `at`, into s_base (and the masks into s_mask, when given): thread k of
// NTH takes masks [k*per, k*per + per). Returns the chunk's total.
template <int NTH>
__device__ __forceinline__ uint32_t chunk_scan(const uint32_t* mk, int64_t M,
                                               int64_t i0, int nm, uint32_t at,
                                               uint32_t* s_mask,
                                               uint32_t* s_base, uint32_t* ws) {
  constexpr int PER = CH_MAX / NTH;          // masks a thread takes, at most
  const int tid = threadIdx.x, per = (nm + NTH - 1) / NTH;
  uint32_t v[PER], cnt = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = tid * per + k;
    v[k] = k < per && j < nm && i0 + j < M ? mk[i0 + j] : 0u;
    cnt += __popc(v[k]);
  }
  uint32_t total;
  at += block_inclusive<NTH>(cnt, ws, total) - cnt;
  if (s_mask) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid * per + k;
      if (k < per && j < nm) {
        s_mask[j] = v[k];
        s_base[j] = at;
        at += __popc(v[k]);
      }
    }
  }
  return total;
}

// Scan level 1: the popcount sum of each chunk. Grid (any, R), SCAN_T
// threads.
__global__ void __launch_bounds__(SCAN_T)
scan_sums_kernel(const int64_t* __restrict__ meta,
                 const uint32_t* __restrict__ masks_all,
                 uint32_t* __restrict__ sums_all) {
  __shared__ uint32_t ws[SCAN_T / 32];
  const int r = blockIdx.y;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t M = n_masks(m), base = enc_base(m, r), nch = n_chunks(m);
  const int nm = SB * (int)((m[2] + 31) >> 5);
  const uint32_t* mk = masks_all + (base >> 4);
  uint32_t* sums = sums_all + (base >> 7) + r;
  for (int64_t c = blockIdx.x; c < nch; c += gridDim.x) {
    const uint32_t total =
        chunk_scan<SCAN_T>(mk, M, c * nm, nm, 0u, nullptr, nullptr, ws);
    if (threadIdx.x == 0) sums[c] = total;
  }
}

// Scan level 2, one block per stream: the chunk sums -> their exclusive
// prefix, in place; p_out[r] = out_len - S, the stream's first word.
__global__ void __launch_bounds__(1024)
scan_partials_kernel(const int64_t* __restrict__ meta,
                     uint32_t* __restrict__ sums_all,
                     int64_t* __restrict__ p_out) {
  __shared__ uint32_t ws[32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t nch = n_chunks(m);
  uint32_t* sums = sums_all + (enc_base(m, r) >> 7) + r;
  uint32_t run = 0;
  for (int64_t c0 = 0; c0 < nch; c0 += 1024) {
    const int64_t i = c0 + tid;
    const uint32_t v = i < nch ? sums[i] : 0u;
    uint32_t total;
    const uint32_t inc = block_inclusive<1024>(v, ws, total);
    if (i < nch) sums[i] = run + inc - v;
    run += total;
  }
  if (tid == 0) p_out[r] = m[6] - (int64_t)run;
}

// Each emitted word (t, l), at (t/8)*8N + 8l + t%8 in pass 1's scratch, to
// words[out_off + p_out + (words of steps < t) + (words of step t in lanes
// < l)]. A block takes one chunk (steps 8c .. 8c+7) and SCATTER_T of its lanes:
// each thread loads its lane's 8 words with one 16-byte load, the block
// scans the chunk's masks from the chunk's prefix meanwhile, and the thread
// stores its flagged words. Grid (any, R).
__global__ void __launch_bounds__(SCATTER_T)
scatter_kernel(const int64_t* __restrict__ meta,
               const uint32_t* __restrict__ masks_all,
               const uint32_t* __restrict__ sums_all,
               const uint16_t* __restrict__ wscr_all,
               const int64_t* __restrict__ p_out,
               uint16_t* __restrict__ words) {
  __shared__ uint32_t s_mask[CH_MAX], s_base[CH_MAX], ws[SCATTER_T / 32];
  const int r = blockIdx.y, tid = threadIdx.x;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t N = m[2], K = m[3], M = n_masks(m), base = enc_base(m, r);
  const int nw = (int)((N + 31) >> 5), nm = SB * nw;
  const int64_t nch = n_chunks(m), parts = (N + SCATTER_T - 1) / SCATTER_T;
  const uint32_t* mk = masks_all + (base >> 4);
  const uint32_t* sums = sums_all + (base >> 7) + r;
  const uint4* wscr = (const uint4*)(wscr_all + base);   // block c at c*N
  uint16_t* out = words + m[4] + p_out[r];
  for (int64_t g = blockIdx.x; g < nch * parts; g += gridDim.x) {
    const int64_t c = g / parts, l = (g % parts) * SCATTER_T + tid;
    const uint4 w8 = l < N ? wscr[c * N + l] : make_uint4(0u, 0u, 0u, 0u);
    chunk_scan<SCATTER_T>(mk, M, c * nm, nm, sums[c], s_mask, s_base, ws);
    __syncthreads();
    if (l < N) {
      const uint32_t wv[4] = {w8.x, w8.y, w8.z, w8.w};
      const int w = (int)(l >> 5);
      const uint32_t below = (1u << (l & 31)) - 1u;
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const uint32_t mm = SB * c + j < K ? s_mask[j * nw + w] : 0u;
        if ((mm >> (l & 31)) & 1u)
          out[s_base[j * nw + w] + __popc(mm & below)] =
              (uint16_t)(wv[j >> 1] >> (16 * (j & 1)));
      }
    }
    __syncthreads();
  }
}

constexpr int ENC_BLOCKS = 1024;   // per launch of a grid-stride pass

// work: device scratch of encode_work_bytes(order, R, n) bytes
// (ops/rans_cuda.py), laid out by EncWork (rans_common.cuh).
template <int ORDER>
int launch_encode(const void* data, const void* meta, const void* tab,
                  void* work, void* words, void* p_out, void* states, int R,
                  int64_t n, cudaStream_t stream) {
  const EncWork wk(work, ORDER, R, n);
  const int64_t* mp = (const int64_t*)meta;
  const int32_t* tp = (const int32_t*)tab;
  cudaError_t e;
  if (ORDER == 1) {
    o1_enc_entries_kernel<<<dim3(256, R), 256, 0, stream>>>(tp, wk.ent);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // grid-stride passes, a column of blocks per stream sized for a stream of
  // the mean length: stripe tiles of 32 lanes x 64 steps (about n/2048),
  // scan chunks and scatter (chunk, 1024 lanes) items (about n/8192)
  const int64_t mean = n / R;
  const int gs = (int)std::min<int64_t>(mean / 2048 + 8, ENC_BLOCKS);
  const int gc = (int)std::min<int64_t>(mean / 8192 + 8, ENC_BLOCKS);
  stripe_kernel<<<dim3(gs, R), 256, 0, stream>>>(mp, (const uint8_t*)data,
                                                 wk.rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  encode_lanes_kernel<ORDER, true><<<dim3(MAX_LANES / EB, R), EB, 0, stream>>>(
      mp, tp, wk.rows, wk.ent, wk.words, wk.masks, (uint32_t*)states);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_sums_kernel<<<dim3(gc, R), SCAN_T, 0, stream>>>(mp, wk.masks, wk.sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_partials_kernel<<<R, 1024, 0, stream>>>(mp, wk.sums, (int64_t*)p_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<dim3(gc, R), SCATTER_T, 0, stream>>>(
      mp, wk.masks, wk.sums, wk.words, (const int64_t*)p_out,
      (uint16_t*)words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n: the R streams' symbols in all (data's length); work: device scratch of
// encode_work_bytes(order, R, n) bytes (ops/rans_cuda.py). Fills words
// backward from each stream's out_len, p_out (R) and states.
int rans_encode_o0(const void* data, const void* meta, const void* tab,
                   void* work, void* words, void* p_out, void* states, int R,
                   long long n, void* stream) {
  return launch_encode<0>(data, meta, tab, work, words, p_out, states, R, n,
                          (cudaStream_t)stream);
}

int rans_encode_o1(const void* data, const void* meta, const void* tab,
                   void* work, void* words, void* p_out, void* states, int R,
                   long long n, void* stream) {
  return launch_encode<1>(data, meta, tab, work, words, p_out, states, R, n,
                          (cudaStream_t)stream);
}

// work: device scratch of decode_work_bytes(order, R, n_out) bytes
// (ops/rans_cuda.py): order 1's slot entries, then the rows of symbols.
int rans_decode_o0(const void* words, const void* meta, const void* tab,
                   void* work, void* out, int R, void* stream) {
  return launch_decode<0>(words, meta, tab, work, out, R,
                          (cudaStream_t)stream);
}

int rans_decode_o1(const void* words, const void* meta, const void* tab,
                   void* work, void* out, int R, void* stream) {
  return launch_decode<1>(words, meta, tab, work, out, R,
                          (cudaStream_t)stream);
}

}  // extern "C"

// RANS-W32x16 entropy coder: four hand-written Hopper kernels (sm_90a).
//
// The stream format is normative in genozip_tpu_torch/ops/rans_np.py (a copy
// of genozip_tpu/ops/rans_np.py): N interleaved lanes (lane l codes the
// symbol chunk [l*K, min((l+1)*K, n))), a 32-bit state in [2^16, 2^32), a
// 12-bit scale, at most one u16 renorm word per symbol, and one shared word
// stream in (step, lane) order. Each kernel's output is byte-identical to
// rans_np's (the host frames header and states).
//
// What the kernels replace (genozip_tpu/ops/rans_pallas.py):
//   rans_encode_o0_kernel  <- K1 _encode_many_kernel_v6 (encode_many_v6)
//   rans_decode_o0_kernel  <- K2 _decode_many_kernel_v6 (decode_many_v6)
//                             and K7 _decode_many_kernel (decode_many)
//   rans_encode_o1_kernel  <- K3 _encode_many_kernel_o1v6 (encode_many_o1_v6)
//                             and K5 _encode_many_o1_kernel (encode_many_o1)
//   rans_decode_o1_kernel  <- K4 _decode_many_kernel_o1v6 (decode_many_o1_v6)
//                             and K6 _decode_many_o1_kernel (decode_many_o1)
//
// What bounds them on this card: not bytes or arithmetic. Every step of a
// stream depends on the step before it, because a lane's renorm word lands at
// a position ranked over every lane of that step, and the next step's word
// pointer depends on how many lanes emitted. So a stream is a serial chain of
// K = n/N steps, each a block-wide scan, and the time is K times the latency
// of one step.
//
// What the design does about it: one block of 1024 threads per stream and
// one launch for R streams, so R chains run side by side on R SMs. Each
// thread owns lanes tid + j*1024 (j < 8, N <= 8192) with their states in
// registers. The per-step rank is a warp __ballot_sync/__popc plus one
// exclusive scan over the warp totals in shared memory, double-buffered so a
// step costs two barriers (rans_common.cuh). The TPU workarounds (float limb
// division, one-hot matmul lookups, lane-roll scans, padded word blocks) have
// no place here.
//
// The encoders divide x/f and x%f exactly in u32, with the order-0 (freq,
// cum) table in shared memory and the order-1 tables in global memory.
//
// The decoders keep device memory off a step's critical path:
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

// Encode meta row: data_off, n, N, K, out_off, state_off, out_len, 0.
// tab: per stream, freq then cum (int32), 256 each (order 0) or 256x256
// [ctx][sym] each (order 1). words: u16 buffer of out_len per stream, filled
// backward; p_out: first word written; states: N final states per stream.
template <int ORDER>
__global__ void __launch_bounds__(NT)
rans_encode_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ meta,
                   const int32_t* __restrict__ tab,
                   uint16_t* __restrict__ words, int64_t* __restrict__ p_out,
                   uint32_t* __restrict__ states) {
  __shared__ uint32_t s_fc[256];
  __shared__ uint32_t cnt[2 * JMAX * NW];
  __shared__ uint32_t tot[2];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t n = m[1], N = m[2], K = m[3];
  const uint8_t* d = data + m[0];
  uint16_t* w = words + m[4];
  const int J = (int)((N + NT - 1) / NT);
  const int32_t* f2 = tab + (int64_t)r * 2 * 65536;   // order 1
  const int32_t* c2 = f2 + 65536;
  if (ORDER == 0) {
    // (f, c) packed f | c << 16: f <= 4096, c < 4096
    const int32_t* t0 = tab + (int64_t)r * 512;
    for (int i = tid; i < 256; i += NT)
      s_fc[i] = (uint32_t)t0[i] | ((uint32_t)t0[256 + i] << 16);
    __syncthreads();
  }
  uint32_t x[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) x[j] = RANS_L;
  int64_t p = m[6];
  for (int64_t t = K - 1; t >= 0; --t) {
    uint32_t fc[JMAX], act = 0, emit = 0;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      fc[j] = 1;
      const int64_t l = (int64_t)j * NT + tid;
      const int64_t i = l * K + t;
      if (j < J && l < N && i < n) {
        const uint32_t s = d[i];
        if (ORDER == 0) {
          fc[j] = s_fc[s];
        } else {
          const uint32_t ctx = t ? d[i - 1] : 0u;
          fc[j] = (uint32_t)f2[ctx * 256 + s] |
                  ((uint32_t)c2[ctx * 256 + s] << 16);
        }
        act |= 1u << j;
        // f << 20 in 64 bits: a one-symbol alphabet has f = 4096
        if ((uint64_t)x[j] >= ((uint64_t)(fc[j] & 0xffffu) << 20))
          emit |= 1u << j;
      }
    }
    uint32_t rank[JMAX];
    const uint32_t S = block_rank(emit, J, (int)(t & 1), cnt, tot, rank);
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if ((emit >> j) & 1u) {
        w[p - S + rank[j]] = (uint16_t)(x[j] & 0xffffu);
        x[j] >>= 16;
      }
      if ((act >> j) & 1u) {
        const uint32_t f = fc[j] & 0xffffu, c = fc[j] >> 16;
        x[j] = ((x[j] / f) << SCALE_BITS) + (x[j] % f) + c;
      }
    }
    p -= S;
  }
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int64_t l = (int64_t)j * NT + tid;
    if (j < J && l < N) states[m[5] + l] = x[j];
  }
  if (tid == 0) p_out[r] = p;
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

}  // namespace

extern "C" {

int rans_encode_o0(const void* data, const void* meta, const void* tab,
                   void* words, void* p_out, void* states, int R,
                   void* stream) {
  rans_encode_kernel<0><<<R, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)meta, (const int32_t*)tab,
      (uint16_t*)words, (int64_t*)p_out, (uint32_t*)states);
  return (int)cudaGetLastError();
}

int rans_encode_o1(const void* data, const void* meta, const void* tab,
                   void* words, void* p_out, void* states, int R,
                   void* stream) {
  rans_encode_kernel<1><<<R, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)meta, (const int32_t*)tab,
      (uint16_t*)words, (int64_t*)p_out, (uint32_t*)states);
  return (int)cudaGetLastError();
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

// Microbenchmarks of the rANS decode and encode steps on Hopper (sm_90a). Not
// part of the coder: chip_smoke.py builds this file beside rans.cu and times
// it.
//
//   micro_chain          the chain floor: K steps of the word ranking alone
//                        (no loads, no stores), the least a one-block-per-
//                        stream design can take, since the format chains the
//                        steps; block_rank (lanes j*1024 + tid, as the
//                        encoders and decoders before their redesigns) or
//                        block_rank_runs (lanes tid*J + j, the decoders).
//   micro_encode_v3_o0/1 a copy of the encoder before the lane-parallel
//                        redesign: one block per stream, block_rank a step.
//   micro_encode_pass1   rans.cu's encoder pass 1 (encode_lanes_kernel)
//                        alone, with or without its word stores.
//   micro_encode_chain   the encoder's chain floor: pass 1's arithmetic
//                        alone, with the emit compare in 64 or 32 bits.
//   micro_decode_v2_o0/1 a copy of the decoder as it was before the shared-
//                        memory redesign (one byte store per lane per step
//                        to device memory, the renorm word loaded from
//                        device memory, two table lookups), with the symbol
//                        stores (STORE) and the renorm-word loads (LOAD)
//                        switched off in turn by template flags.
//   micro_cluster_sync   the cost of one barrier.cluster over 1-8 blocks of
//                        1024 threads (and of __syncthreads for comparison).
//   micro_decode_tile_o0/1  the decoder with its symbols staged in a shared-
//                        memory tile of T steps x N lanes and written every T
//                        steps straight to each lane's chunk of the output
//                        (T = 8 at N = 8192), in place of rans.cu's rows in
//                        the format's (step, lane) order and unstripe pass.
// Each returns cudaGetLastError() (or the launch error).

#include <cooperative_groups.h>

#include "rans_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rans;

// ---- (a) the chain floor --------------------------------------------------

__global__ void __launch_bounds__(NT)
chain_kernel(int N, int64_t K, uint32_t* __restrict__ sink) {
  __shared__ uint32_t cnt[2 * JMAX * NW];
  __shared__ uint32_t tot[2];
  const int tid = threadIdx.x;
  const int J = (N + NT - 1) / NT;
  uint32_t h = 0x9e3779b9u * (uint32_t)(tid + 1), acc = 0;
  for (int64_t t = 0; t < K; ++t) {
    h ^= h << 13;                 // xorshift: about half the lanes flagged
    h ^= h >> 17;
    h ^= h << 5;
    uint32_t flags = tid < N ? h : 0u, rank[JMAX];   // bits j >= J unread
    const uint32_t S = block_rank(flags, J, (int)(t & 1), cnt, tot, rank);
    acc += S + rank[0];
  }
  if (acc == 0x5eed5eedu) sink[tid] = acc;   // keeps the chain alive
}

// the same with the decoders' ranking: thread tid owns lanes tid*J + j
__global__ void __launch_bounds__(NT)
chain_runs_kernel(int N, int64_t K, uint32_t* __restrict__ sink) {
  __shared__ uint32_t cnt[2 * NW];
  __shared__ uint32_t tot[2];
  const int tid = threadIdx.x;
  const int J = (N + NT - 1) / NT;
  const uint32_t mask = J >= 32 ? ~0u : (1u << J) - 1u;
  uint32_t h = 0x9e3779b9u * (uint32_t)(tid + 1), acc = 0;
  for (int64_t t = 0; t < K; ++t) {
    h ^= h << 13;
    h ^= h >> 17;
    h ^= h << 5;
    uint32_t first;
    const uint32_t flags = tid * J < N ? h & mask : 0u;
    const uint32_t S = block_rank_runs(flags, (int)(t & 1), cnt, tot, first);
    acc += S + first;
  }
  if (acc == 0x5eed5eedu) sink[tid] = acc;
}

// ---- (b) the decoder before the redesign, with switches -------------------

template <int ORDER, bool STORE, bool LOAD>
__global__ void __launch_bounds__(NT)
decode_v2_kernel(const uint16_t* __restrict__ words,
                 const int64_t* __restrict__ meta,
                 const int32_t* __restrict__ tab,
                 const uint8_t* __restrict__ s2s, uint8_t* __restrict__ out) {
  __shared__ uint32_t s_fc[256];
  __shared__ uint8_t s_sym[1 << SCALE_BITS];
  __shared__ uint32_t cnt[2 * JMAX * NW];
  __shared__ uint32_t tot[2];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t nwords = m[1], n = m[2], N = m[3], K = m[4];
  const uint16_t* w = words + m[0];
  uint8_t* o = out + m[5];
  const int J = (int)((N + NT - 1) / NT);
  const int32_t* f2 = tab + (int64_t)r * 2 * 65536;
  const int32_t* c2 = f2 + 65536;
  const uint8_t* sym2 = s2s + ((int64_t)r << 20);
  if (ORDER == 0) {
    const int32_t* t0 = tab + (int64_t)r * 512;
    for (int i = tid; i < 256; i += NT)
      s_fc[i] = (uint32_t)t0[i] | ((uint32_t)t0[256 + i] << 16);
    const uint8_t* s0 = s2s + ((int64_t)r << SCALE_BITS);
    for (int i = tid; i < (1 << SCALE_BITS); i += NT) s_sym[i] = s0[i];
    __syncthreads();
  }
  uint32_t x[JMAX], ctx[JMAX], acc = 0;
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int64_t l = (int64_t)j * NT + tid;
    x[j] = 0;
    ctx[j] = 0;
    if (j < J && l < N && 2 * l + 1 < nwords)
      x[j] = ((uint32_t)w[2 * l] << 16) | w[2 * l + 1];
  }
  int64_t p = 2 * N;
  for (int64_t t = 0; t < K; ++t) {
    uint32_t need = 0;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int64_t l = (int64_t)j * NT + tid;
      const int64_t i = l * K + t;
      if (j < J && l < N && i < n) {
        const uint32_t slot = x[j] & SLOT_MASK;
        uint32_t s, fc;
        if (ORDER == 0) {
          s = s_sym[slot];
          fc = s_fc[s];
        } else {
          s = sym2[(ctx[j] << SCALE_BITS) + slot];
          fc = (uint32_t)f2[ctx[j] * 256 + s] |
               ((uint32_t)c2[ctx[j] * 256 + s] << 16);
          ctx[j] = s;
        }
        x[j] = (fc & 0xffffu) * (x[j] >> SCALE_BITS) + slot - (fc >> 16);
        if (STORE) o[i] = (uint8_t)s;
        else acc += s;
        if (x[j] < RANS_L) need |= 1u << j;
      }
    }
    uint32_t rank[JMAX];
    const uint32_t S = block_rank(need, J, (int)(t & 1), cnt, tot, rank);
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if ((need >> j) & 1u) {
        const int64_t q = p + rank[j];
        const uint32_t v = LOAD ? (q < nwords ? (uint32_t)w[q] : 0u)
                                : (uint32_t)(q & 0xffff);
        x[j] = (x[j] << 16) | v;
      }
    }
    p += S;
  }
  if (!STORE && acc == 0x5eed5eedu) o[tid] = (uint8_t)acc;
}

template <int ORDER>
int launch_v2(int variant, const void* words, const void* meta,
              const void* tab, const void* s2s, void* out, int R,
              cudaStream_t st) {
  auto* wp = (const uint16_t*)words;
  auto* mp = (const int64_t*)meta;
  auto* tp = (const int32_t*)tab;
  auto* sp = (const uint8_t*)s2s;
  auto* op = (uint8_t*)out;
  switch (variant) {      // bit 0: symbol stores on, bit 1: word loads on
    case 3: decode_v2_kernel<ORDER, true, true><<<R, NT, 0, st>>>(wp, mp, tp, sp, op); break;
    case 2: decode_v2_kernel<ORDER, false, true><<<R, NT, 0, st>>>(wp, mp, tp, sp, op); break;
    case 1: decode_v2_kernel<ORDER, true, false><<<R, NT, 0, st>>>(wp, mp, tp, sp, op); break;
    default: decode_v2_kernel<ORDER, false, false><<<R, NT, 0, st>>>(wp, mp, tp, sp, op); break;
  }
  return (int)cudaGetLastError();
}

// ---- the decoder with a shared-memory tile of T steps x N lanes ------------

constexpr int SMEM_LIMIT = 232448;             // 227 KB a block may use
constexpr int MAX_LANES = NT * JMAX;
constexpr int SCAN_BYTES = (2 * JMAX * NW + 4) * 4;
constexpr int O0_ENT_BYTES = (1 << SCALE_BITS) * 4;

// order 0 takes all 227 KB; order 1 stops at T = 8 for N = 8192 and leaves
// the rest to L1, which caches its slot entries
template <int ORDER>
__host__ __device__ constexpr int tile_smem() {
  return ORDER == 0 ? SMEM_LIMIT
                    : WordRing::BYTES + SCAN_BYTES + MAX_LANES * 12;
}

template <int ORDER>
__global__ void __launch_bounds__(NT)
decode_tile_kernel(const uint16_t* __restrict__ words,
                   const int64_t* __restrict__ meta,
                   const int32_t* __restrict__ tab,
                   const uint32_t* __restrict__ slots,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* cnt = (uint32_t*)(smem + WordRing::BYTES);         // 2 * JMAX * NW
  uint32_t* tot = cnt + 2 * JMAX * NW;                    // 2 (+2 spare)
  uint32_t* s_ent = (uint32_t*)(smem + WordRing::BYTES + SCAN_BYTES);
  uint8_t* tile = (uint8_t*)s_ent + (ORDER == 0 ? O0_ENT_BYTES : 0);
  const int tile_bytes = tile_smem<ORDER>() - (int)(tile - smem);

  const int r = blockIdx.x, tid = threadIdx.x;
  const int64_t* m = meta + (int64_t)r * META;
  const int64_t nwords = m[1], n = m[2], N = m[3], K = m[4];
  const uint16_t* w = words + m[0];
  uint8_t* o = out + m[5];
  const int J = (int)((N + NT - 1) / NT);
  const uint32_t* sl = slots + ((int64_t)r << 20);        // order 1

  // tile: T steps x N lanes, lane l's T bytes at l * TS
  int lgT = 5;
  while (lgT > 3 && N * ((1 << lgT) + 4) > tile_bytes) --lgT;
  const int T = 1 << lgT, TS = T + 4;

  if (ORDER == 0) {
    uint32_t* s_f = (uint32_t*)tile;                      // scratch
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

  uint32_t x[JMAX], ctx[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int64_t l = (int64_t)j * NT + tid;
    x[j] = 0;
    ctx[j] = 0;
    if (j < J && l < N && 2 * l + 1 < nwords)
      x[j] = ((uint32_t)w[2 * l] << 16) | w[2 * l + 1];
  }
  // lanes below lf hold K symbols, lane lf holds rem (< K), the rest none
  const int lf = K ? (int)(n / K) : 0;
  const int64_t rem = K ? n % K : 0;
  const int tb = tid * TS;        // this thread's lane j at tb + j * NT * TS
  WordRing ring;
  ring.init(smem, w, nwords, N);
  int64_t p = 2 * N;
  ring.refill(p, tid, NT);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int64_t t = 0; t < K; ++t) {
    const int tt = (int)(t & (T - 1));
    const bool tail = t < rem;
    uint32_t need = 0;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int l = j * NT + tid;
      if (j < J && (l < lf || (l == lf && tail))) {
        const uint32_t slot = x[j] & SLOT_MASK;
        const uint32_t e = ORDER == 0 ? s_ent[slot]
                                      : __ldg(sl + ((ctx[j] << SCALE_BITS) | slot));
        const uint32_t s = e & 0xffu;
        x[j] = (((e >> 8) & 0xfffu) + 1u) * (x[j] >> SCALE_BITS) + (e >> 20);
        tile[tb + j * NT * TS + tt] = (uint8_t)s;
        if (ORDER == 1) ctx[j] = s;
        if (x[j] < RANS_L) need |= 1u << j;
      }
    }
    const bool flush = tt == T - 1 || t == K - 1;
    const int64_t t0 = t - tt;
    uint32_t rank[JMAX];
    const uint32_t S = block_rank(need, J, (int)(t & 1), cnt, tot, rank, [&] {
      if (flush && tid >= 32) {
        // steps t0..t of every lane, by warps 1-31 while warp 0 scans: one
        // warp store covers the next T bytes of 32/T lanes, consecutive in
        // each lane's chunk
        const int f = tid - 32, lpp = (NT - 32) >> lgT;   // lanes per pass
        const int u = f & (T - 1);
        if (u <= tt) {
          int l = f >> lgT, ti = l * TS + u;
          int64_t gi = (int64_t)l * K + t0 + u;
          const int64_t gstep = (int64_t)lpp * K;
          for (; l < N && gi < n; l += lpp, ti += lpp * TS, gi += gstep)
            o[gi] = tile[ti];
        }
      }
      ring.refill(p, tid, NT);
      cp_async_commit();
      cp_async_wait<2>();         // the copies of step t-2 have landed
    });
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      if ((need >> j) & 1u) {
        x[j] = (x[j] << 16) | ring.word(p + rank[j]);
      }
    }
    p += S;
  }
}

template <int ORDER>
int launch_tile(const void* words, const void* meta, const void* tab,
                void* slots, void* out, int R, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_tile_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_smem<ORDER>());
  if (e != cudaSuccess) return (int)e;
  if (ORDER == 1) {
    o1_slots_kernel<<<dim3(256, R), 256, 0, stream>>>((const int32_t*)tab,
                                                      (uint32_t*)slots);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  decode_tile_kernel<ORDER><<<R, NT, tile_smem<ORDER>(), stream>>>(
      (const uint16_t*)words, (const int64_t*)meta, (const int32_t*)tab,
      (const uint32_t*)slots, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// ---- (c) barrier.cluster --------------------------------------------------

template <bool CLUSTER>
__global__ void __launch_bounds__(NT)
sync_kernel(int iters, uint32_t* __restrict__ sink) {
  uint32_t acc = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    if (CLUSTER) cg::this_cluster().sync();
    else __syncthreads();
    acc = acc * 1664525u + 1013904223u;
  }
  if (acc == 0x5eed5eedu) sink[threadIdx.x] = acc;
}

// ---- (d) the encoder before the lane-parallel redesign --------------------
//
// One 1024-thread block per stream, lanes j*1024 + tid, the symbols read
// straight from each lane's chunk, a block_rank every step and exact u32
// division; same arguments and output as rans.cu's encoders, no work buffer.
template <int ORDER>
__global__ void __launch_bounds__(NT)
encode_v3_kernel(const uint8_t* __restrict__ data,
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

// ---- (e) the encoder's chain floor -----------------------------------------
//
// K steps of pass 1's arithmetic alone (emit compare, ballot, umulhi
// division, multiply-add), one thread per lane, 16 entries held in
// registers: no loads, no stores. WIDE: the emit compare in 64 bits, as
// encode_lanes_kernel does; else the same test in 32 bits, x > (f << 20) - 1.
template <bool WIDE>
__global__ void __launch_bounds__(EB)
enc_chain_kernel(const uint2* __restrict__ ent16, int K,
                 uint32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  uint2 e[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) e[i] = ent16[i];
  uint32_t x = RANS_L + threadIdx.x, mine = 0;
  for (int t = 0; t < K; t += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const uint32_t f = e[u].x & 0x1fffu, bias = (e[u].x >> 13) & 0x1fffu;
      const bool emit = WIDE ? (uint64_t)x >= ((uint64_t)f << 20)
                             : x > (f << 20) - 1u;
      const uint32_t mask = __ballot_sync(0xffffffffu, emit);
      mine = lane == u ? mask : mine;
      const uint32_t xs = emit ? x >> 16 : x;
      const uint32_t hi = __umulhi(xs, e[u].y);
      const uint32_t q = (hi + ((xs - hi) >> 1)) >> (e[u].x >> 26);
      x = xs + bias + q * ((1u << SCALE_BITS) - f);
    }
  }
  if (x + mine == 0x5eed5eedu) sink[threadIdx.x] = x;   // keeps the chain
}

}  // namespace

extern "C" {

// runs = 0: block_rank over lanes j*1024 + tid (the encoders'); 1:
// block_rank_runs over lanes tid*J + j (the decoders')
int micro_chain(int runs, int N, long long K, void* sink, void* stream) {
  if (runs)
    chain_runs_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(N, (int64_t)K,
                                                          (uint32_t*)sink);
  else
    chain_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(N, (int64_t)K,
                                                      (uint32_t*)sink);
  return (int)cudaGetLastError();
}

int micro_decode_v2_o0(int variant, const void* words, const void* meta,
                       const void* tab, const void* s2s, void* out, int R,
                       void* stream) {
  return launch_v2<0>(variant, words, meta, tab, s2s, out, R,
                      (cudaStream_t)stream);
}

int micro_decode_v2_o1(int variant, const void* words, const void* meta,
                       const void* tab, const void* s2s, void* out, int R,
                       void* stream) {
  return launch_v2<1>(variant, words, meta, tab, s2s, out, R,
                      (cudaStream_t)stream);
}

// slots: order 1's R x 256 x 4096 u32 slot entries (unused by order 0)
int micro_decode_tile_o0(const void* words, const void* meta, const void* tab,
                         void* slots, void* out, int R, void* stream) {
  return launch_tile<0>(words, meta, tab, slots, out, R, (cudaStream_t)stream);
}

int micro_decode_tile_o1(const void* words, const void* meta, const void* tab,
                         void* slots, void* out, int R, void* stream) {
  return launch_tile<1>(words, meta, tab, slots, out, R, (cudaStream_t)stream);
}

// cluster = 0: one block and __syncthreads; 1..8: one cluster of that many
// blocks and barrier.cluster.
int micro_cluster_sync(int cluster, int iters, void* sink, void* stream) {
  if (cluster == 0) {
    sync_kernel<false><<<1, NT, 0, (cudaStream_t)stream>>>(iters,
                                                           (uint32_t*)sink);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, sync_kernel<true>, iters,
                                     (uint32_t*)sink);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the encoder before the redesign: the same output as rans_encode_o0/o1
int micro_encode_v3_o0(const void* data, const void* meta, const void* tab,
                       void* words, void* p_out, void* states, int R,
                       void* stream) {
  encode_v3_kernel<0><<<R, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)meta, (const int32_t*)tab,
      (uint16_t*)words, (int64_t*)p_out, (uint32_t*)states);
  return (int)cudaGetLastError();
}

int micro_encode_v3_o1(const void* data, const void* meta, const void* tab,
                       void* words, void* p_out, void* states, int R,
                       void* stream) {
  encode_v3_kernel<1><<<R, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)meta, (const int32_t*)tab,
      (uint16_t*)words, (int64_t*)p_out, (uint32_t*)states);
  return (int)cudaGetLastError();
}

// The encoders' pass 1 alone (encode_lanes_kernel, rans_common.cuh) on a
// work buffer whose rows and order-1 entries an earlier rans_encode_o0/o1
// call of the same streams filled; store = 0 drops its word stores.
int micro_encode_pass1(int order, int store, const void* meta, const void* tab,
                       void* work, void* states, int R, long long n,
                       void* stream) {
  const EncWork wk(work, order, R, n);
  const dim3 grid(NT * JMAX / EB, R);
  auto* mp = (const int64_t*)meta;
  auto* tp = (const int32_t*)tab;
  auto* sp = (uint32_t*)states;
  cudaStream_t st = (cudaStream_t)stream;
  if (order == 0 && store)
    encode_lanes_kernel<0, true><<<grid, EB, 0, st>>>(mp, tp, wk.rows, wk.ent, wk.words, wk.masks, sp);
  else if (order == 0)
    encode_lanes_kernel<0, false><<<grid, EB, 0, st>>>(mp, tp, wk.rows, wk.ent, wk.words, wk.masks, sp);
  else if (store)
    encode_lanes_kernel<1, true><<<grid, EB, 0, st>>>(mp, tp, wk.rows, wk.ent, wk.words, wk.masks, sp);
  else
    encode_lanes_kernel<1, false><<<grid, EB, 0, st>>>(mp, tp, wk.rows, wk.ent, wk.words, wk.masks, sp);
  return (int)cudaGetLastError();
}

// wide = 1: the emit compare in 64 bits (as shipped); 0: in 32 bits. N
// lanes, K steps; ent16: 16 packed encode entries (rans_torch.enc_entries).
int micro_encode_chain(int wide, int N, int K, const void* ent16, void* sink,
                       void* stream) {
  const int blocks = (N + EB - 1) / EB;
  if (wide)
    enc_chain_kernel<true><<<blocks, EB, 0, (cudaStream_t)stream>>>(
        (const uint2*)ent16, K, (uint32_t*)sink);
  else
    enc_chain_kernel<false><<<blocks, EB, 0, (cudaStream_t)stream>>>(
        (const uint2*)ent16, K, (uint32_t*)sink);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Positional Burrows-Wheeler transform of haplotype matrices: hand-written
// Hopper kernels (sm_90a) for pbwt_encode and pbwt_decode.
//
// The function is genozip_tpu's PBWT of the VCF genotype matrix
// (genozip_tpu/ops/pbwt.py `pbwt_encode_jnp` :46 and `pbwt_decode_jnp` :61,
// XLA device functions under lax.scan; no Pallas kernel): for each variant
// row i of the (n, H) uint8 matrix, in order, the row is emitted in the
// current permutation order, y[j] = A[i, perm[j]] (decode: A[i, perm[j]] =
// Y[i, j]), and then perm is stably sorted by y. The plain version is
// ops/pbwt_torch.py (with torch mirrors of the pieces below); the two are
// equal, and equal to pbwt_encode_np.
//
// What bounds them: not bytes (2 n H) nor operations (a few a value) but a
// serial chain of rows.
//   - pbwt_encode: each row's gather waits on the previous row's sort, so a
//     row is a gather, a stable counting sort and two block barriers.
//   - pbwt_decode: a row's sort order sigma_i = argsort(Y_i, stable)
//     depends on Y_i alone, and perm_{i+1} = perm_i[sigma_i]. Phase 1
//     (sigma_kernel, over the whole card; `pbwt_sigmas` alone) sorts every
//     row and composes the sort orders within groups of rows; the chain
//     (phase 2) then takes one barrier a group, its gathers all from the
//     group's first perm.
// chip_smoke.py times both against the rows' floors (`pbwt_row_floor`
// versions 2 and 3, csrc/devfns_micro.cu: the same rows with no device
// memory).
//
// Layout (one block a matrix on each chain; R matrices a launch through a
// table of int64 rows (offset of the matrix, n, H, offset in int32 words
// of its scratch)); while H <= SMEM_H = 12,288, in shared memory:
//   encoder: the sort's tables (pbwt_common.cuh; 64,528 bytes at 31
//     sorting warps, 15,376 at 7), perm and its sorted copy as u16 (2 x
//     12,288 x 2 = 49,152) and the row ring (RING_BYTES = 49,184, batches
//     of rows); 162,864 bytes a block. H = 400 uses 1,600 bytes of perm,
//     H = 5,008 20,032.
//   decoder chain: perm (49,152), two groups of staged output rows, three
//     groups of sort orders (u16, rows padded to 8 values) and of Y rows:
//     221,248 bytes; a group is 32 rows at H = 400, 3 at 5,008, 1 at
//     12,288 (`group_rows`).
// Past SMEM_H perm lives in the launch's scratch (int32), rows are read
// from device memory, and the decoder's chain takes a row a barrier and
// scatters straight to A: a shape regime of its own, tested at SMEM_H + 1.
//
// The encoder's row i (pbwt_common.cuh `sort_row`; nw sorting warps and a
// helper warp; sorting warp w takes the contiguous segment of SEG steps of
// 32 values from w SEG 32). Row i starts with its code table (code = the
// number of present values below), which the helper built during row i -
// 1.
//   1. each sorting lane gathers its values v = ring[perm[j]] from shared
//      memory, stores y[j] = v (coalesced) and ranks code(v) within its
//      warp step by step: ceil(log2 np) ballots of the codes' bits, the
//      rank a __popc, the warp's running count of each code in registers
//      (no __match_any_sync and no shared-memory count on the chain up to
//      32 codes); it keeps its codes, perm entries and positions in
//      registers (SEG <= 16) and stores its warp's counts. Row i + 1's
//      values are flagged from the ring: by the helper up to H = 2,048,
//      by the sorting warps past it (the helper's 32 lanes would then
//      hold the row).
//   barrier 1: orders the counts and row i + 1's flags before they are
//      read.
//   2. each sorting warp computes, with no further barrier, its first
//      destination of each code (each code's total over the warps and the
//      warp's column prefix, carried over the codes: two warp reductions a
//      code up to 16 codes, `firsts`, and `place`'s scan past them) and
//      scatters perm into the other buffer; the helper builds row i + 1's
//      code table and clears row i's flags.
//   barrier 2: orders the scatter before the next row's gather, and
//      publishes the code table and the ring's next batch (each thread
//      waits for its own cp.async pieces just before it).
// Rows come into the ring in batches, two batches ahead, by cp.async of
// whole 16-byte pieces (pbwt_common.cuh `Ring`, `Batches`), so no row's
// bytes are loaded from device memory on the chain.
//
// The decoder: phase 1 runs the same sort on every row of Y (a block a
// group of rows, the groups over the card), with the positions j as the
// payload, and composes them: slot i0 + k of the scratch holds rho =
// sigma_i0 o ... o sigma_(i0+k) (u16 up to H = 65,535, int32 past it;
// rows padded to 8 or 4 entries). Its chain keeps perm in shared memory
// and brings the sort orders and Y into rings two groups ahead; a group
// from row i0 stages A[i0 + k, perm_i0[rho_k[j]]] = Y[i0 + k, j] for each
// of its rows (rho_0 the identity), takes perm_new = perm_i0[rho_last],
// and one barrier, which orders all of it and publishes the rings' next
// group; the staged rows are copied out to A with coalesced stores during
// the next group.
// Values are any byte, 0..255 (the VCF's GT uses 0..10 and 254).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "pbwt_common.cuh"

namespace {

using namespace pbwtk;

constexpr int ENC_SMEM = table_bytes(31) + 4 * SMEM_H + RING_BYTES;
constexpr int CHAIN_SMEM = 18 * SMEM_H + 64;        // 221,248 bytes
constexpr int SIGMA_SMEM = table_bytes(31) + 6 * SMEM_H;
constexpr int SIGMA_BLOCKS = 4096;   // phase 1's blocks, over the matrices
constexpr int MAX_GROUP = 32;

// the decoder's rows a group (a barrier of its chain): as many as fit
// three groups of sort orders (u16, rows of Hp) and of Y rows, and two of
// staged output rows, beside perm (4 SMEM_H bytes), up to MAX_GROUP; 1
// past SMEM_H (no chain in shared memory)
__device__ __forceinline__ int group_rows(int H) {
  if (H > SMEM_H) return 1;
  const int Hp = (H + 7) & ~7;
  const int g = (CHAIN_SMEM - 4 * SMEM_H - 64) / (6 * Hp + 5 * H);
  return g < 1 ? 1 : g > MAX_GROUP ? MAX_GROUP : g;
}

// One matrix on the encoder's chain. SMEM: perm (u16) and the ring in
// shared memory, else perm in the scratch (int32) and rows from device
// memory. Warps 0 .. nw - 1 sort, warp nw is the helper.
template <bool SMEM>
__device__ __forceinline__ void encode_matrix(
    const uint8_t* __restrict__ a, uint8_t* __restrict__ y, int64_t n, int H,
    const Tables& tb, unsigned char* extra, int32_t* scratch) {
  using Idx = typename std::conditional<SMEM, uint16_t, int32_t>::type;
  const int t = threadIdx.x, T = blockDim.x, ns = 32 * tb.nw;
  const bool helper = t >= ns;
  // the helper flags narrow rows from the ring; wide ones would hold it
  // past the sorting warps' step 1
  const bool helper_flags = SMEM && H <= HELPER_FLAGS_H;
  const int cls = seg_class(H, tb.nw);
  Idx* src = SMEM ? reinterpret_cast<Idx*>(extra) : (Idx*)scratch;
  Idx* dst = src + (SMEM ? SMEM_H : H);
  Ring ring;
  Batches batches;
  int rb = 0;
  if constexpr (SMEM) {
    ring.init(extra + 4 * SMEM_H, RING_BYTES, a, n * H, H);
    const int K = batch_rows(RING_BYTES, H, 1);
    batches.init(K, 1);
    for (int b = 0; b < 3; b++) ring.fetch(K);
    rb = ring.delta;
  }
  for (int j = t; j < H; j += T) src[j] = (Idx)j;
  if constexpr (SMEM) cp_async_wait<0>();
  __syncthreads();
  for (int j = t; j < H; j += T)
    tb.row_flags(0)[SMEM ? ring.at(rb, j) : a[j]] = 1;
  __syncthreads();
  if (helper) {
    const int np = code_table(tb.row_flags(0), tb.row_codes(0));
    if (t == ns) tb.np[0] = np;
  }
  __syncthreads();
  for (int64_t i = 0; i < n; i++) {
    if constexpr (SMEM)
      if (batches.opens(i + 1)) ring.fetch(batches.K);
    const int rb_next = SMEM ? ring.advance(rb) : 0;
    const uint8_t* arow = a + i * H;
    if (helper) {
      if (helper_flags && i + 1 < n) {        // row i + 1's flags, from
        uint8_t* f = tb.row_flags(i + 1);     // the ring
#pragma unroll 4
        for (int j = t - ns; j < H; j += 32) f[ring.at(rb_next, j)] = 1;
      }
      helper_row(tb, i, i + 1 < n);
    } else {
      uint8_t* yrow = y + i * H;
      sort_row_any(
          tb, cls, tb.np[i & 1], tb.row_codes(i), H,
          [&](int j, bool live, int& v, int& pay) {   // y = row[perm]
            pay = src[j];
            v = SMEM ? ring.at(rb, pay) : arow[pay];
            if (live) yrow[j] = (uint8_t)v;
          },
          [&](int d, int pay) { dst[d] = (Idx)pay; },
          [&]() {                             // row i + 1's flags
            if (!helper_flags && i + 1 < n) {
              uint8_t* f = tb.row_flags(i + 1);
              for (int j = t; j < H; j += ns)
                f[SMEM ? ring.at(rb_next, j) : arow[H + j]] = 1;
            }
          });
    }
    if constexpr (SMEM) batches.end();              // row i + 2's batch
    __syncthreads();                                 // barrier 2
    Idx* tmp = src;
    src = dst;
    dst = tmp;
    rb = rb_next;
  }
  if constexpr (SMEM) cp_async_wait<0>();
}

__global__ void __launch_bounds__(MAX_THREADS)
encode_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
              const int64_t* __restrict__ meta, int32_t* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t off = m[0], n = m[1];
  const int H = (int)m[2];
  if (n == 0 || H == 0) return;          // the same in every thread
  const int nw = (blockDim.x >> 5) - 1;  // sorting warps
  Tables tb;
  tb.carve(smem_raw, nw);
  unsigned char* extra = smem_raw + table_bytes(nw);
  if (H <= SMEM_H)
    encode_matrix<true>(in + off, out + off, n, H, tb, extra, work + m[3]);
  else
    encode_matrix<false>(in + off, out + off, n, H, tb, extra, work + m[3]);
}

// Phase 1 of the decoder, for the rows of one matrix in groups of
// group_rows(H) (the chain's): a block a group (groups blockIdx.x, +
// gridDim.x, ...). Each row is sorted as the encoder's (the positions j
// as the payload: sigma_i = argsort(Y_i, stable)) into shared memory, and
// composed with the group's rows before it: slot i of the scratch gets
// rho = sigma_i0 o ... o sigma_i (rho[j] = rho_prev[sigma_i[j]]), i0 the
// group's first row, so that the chain gathers each row of a group from
// the group's first perm. A group of one row writes sigma as it is (u16,
// or int32 past U16_H: WIDE).
template <bool WIDE>
__device__ __forceinline__ void sigma_groups(const uint8_t* __restrict__ Y,
                                             int64_t n, int H,
                                             const Tables& tb,
                                             unsigned char* extra,
                                             void* sig) {
  using Sig = typename std::conditional<WIDE, int32_t, uint16_t>::type;
  const int t = threadIdx.x, T = blockDim.x, ns = 32 * tb.nw;
  const bool helper = t >= ns;
  const int cls = seg_class(H, tb.nw);
  const int64_t Hp = WIDE ? (H + 3) & ~3 : (H + 7) & ~7;
  const int GS = group_rows(H);
  const int64_t stride = (int64_t)gridDim.x * GS;   // rows between groups
  uint16_t* S = reinterpret_cast<uint16_t*>(extra);  // the row's sigma
  uint16_t* R = S + SMEM_H;                          // rho, two buffers
  int64_t k_row = 0;                   // the block's rows so far
  const int64_t first = (int64_t)blockIdx.x * GS;
  for (int j = t; j < H; j += T) tb.row_flags(0)[Y[first * H + j]] = 1;
  __syncthreads();
  if (helper) {
    const int np = code_table(tb.row_flags(0), tb.row_codes(0));
    if (t == ns) tb.np[0] = np;
  }
  __syncthreads();
  for (int64_t i0 = first; i0 < n; i0 += stride) {
    const int rows = n - i0 < GS ? (int)(n - i0) : GS;
    for (int k = 0; k < rows; k++, k_row++) {
      const int64_t i = i0 + k;
      Sig* out = reinterpret_cast<Sig*>(sig) + i * Hp;
      const int64_t next = k + 1 < rows ? i + 1 : i0 + stride;
      if (helper) {
        helper_row(tb, k_row, next < n);
      } else {
        const uint8_t* row = Y + i * H;
        sort_row_any(
            tb, cls, tb.np[k_row & 1], tb.row_codes(k_row), H,
            [&](int j, bool, int& v, int& pay) {
              v = row[j];
              pay = j;
            },
            [&](int d, int pay) {
              if (GS == 1) out[d] = (Sig)pay;
              else S[d] = (uint16_t)pay;
            },
            [&]() {
              if (next < n) {
                uint8_t* f = tb.row_flags(k_row + 1);
                for (int j = t; j < H; j += ns) f[Y[next * H + j]] = 1;
              }
            });
      }
      __syncthreads();                               // barrier 2
      if (GS > 1) {                   // rho_k = rho_(k-1) o sigma_i
        const uint16_t* prev = R + ((k + 1) & 1) * SMEM_H;
        uint16_t* cur = R + (k & 1) * SMEM_H;
        for (int j = t; j < H; j += T) {
          const uint16_t x = k ? prev[S[j]] : S[j];
          cur[j] = x;
          out[j] = (Sig)x;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
sigma_kernel(const uint8_t* __restrict__ in, const int64_t* __restrict__ meta,
             int32_t* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t* m = meta + (int64_t)blockIdx.y * META;
  const int64_t off = m[0], n = m[1];
  const int H = (int)m[2];
  if ((int64_t)blockIdx.x * group_rows(H) >= n || H == 0) return;
  const int nw = (blockDim.x >> 5) - 1;  // sorting warps
  Tables tb;
  tb.carve(smem_raw, nw);
  __syncthreads();
  unsigned char* extra = smem_raw + table_bytes(nw);
  if (H <= U16_H)
    sigma_groups<false>(in + off, n, H, tb, extra, work + m[3]);
  else
    sigma_groups<true>(in + off, n, H, tb, extra, work + m[3]);
}

// The decoder's chain for one matrix with perm, the rings and the staged
// output rows in shared memory (H <= SMEM_H, sort orders as u16): a group
// of GS rows a barrier. Row i0 + k of the group scatters Y to perm_i0
// [rho_(k-1)[j]] (the identity for k = 0), and the group's last rho gives
// the next perm: every gather of a group reads perm_i0, so only the
// group's barrier orders the chain.
__device__ __forceinline__ void chain_smem(const uint8_t* __restrict__ Y,
                                           uint8_t* __restrict__ A, int64_t n,
                                           int H, const uint16_t* sig,
                                           unsigned char* sm) {
  const int t = threadIdx.x, T = blockDim.x;
  const int Hp = (H + 7) & ~7, GS = group_rows(H);
  const int stage_bytes = (2 * GS * H + 15) & ~15;
  const int sig_cap = 3 * GS * 2 * Hp;
  uint16_t* src = reinterpret_cast<uint16_t*>(sm);
  uint16_t* dst = src + SMEM_H;
  uint8_t* stage = sm + 4 * SMEM_H;                  // 2 x GS rows of H
  Ring sr, yr;                        // sort orders (2 Hp bytes), Y rows
  sr.init(stage + stage_bytes, sig_cap,
          reinterpret_cast<const uint8_t*>(sig), n * 2 * Hp, 2 * Hp);
  yr.init(stage + stage_bytes + sig_cap,
          CHAIN_SMEM - 4 * SMEM_H - stage_bytes - sig_cap, Y, n * H, H);
  Batches batches;                    // a batch a group
  batches.init(1, 0);
  for (int b = 0; b < 3; b++) {
    sr.fetch(GS);
    yr.fetch(GS);
  }
  for (int j = t; j < H; j += T) src[j] = (uint16_t)j;
  cp_async_wait<0>();
  __syncthreads();
  int sb = 0, rb = yr.delta, prev_rows = 0;
  for (int64_t g = 0, i0 = 0; i0 < n; g++, i0 += GS) {
    if (batches.opens(g)) {
      sr.fetch(GS);
      yr.fetch(GS);
    }
    const int rows = n - i0 < GS ? (int)(n - i0) : GS;
    if (g > 0) {                      // the group before, staged
      const uint8_t* prev = stage + ((g - 1) & 1) * GS * H;
      uint8_t* o = A + (i0 - GS) * H;
      for (int x = t; x < prev_rows * H; x += T) o[x] = prev[x];
    }
    uint8_t* st = stage + (g & 1) * GS * H;
    for (int j = t; j < H; j += T) st[src[j]] = yr.at(rb, j);
    int s_k = sb, r_k = rb;
    for (int k = 1; k < rows; k++) {
      const uint16_t* rho = reinterpret_cast<const uint16_t*>(sr.buf + s_k);
      r_k = yr.advance(r_k);
      uint8_t* stk = st + k * H;
      for (int j = t; j < H; j += T) stk[src[rho[j]]] = yr.at(r_k, j);
      s_k = sr.advance(s_k);
    }
    const uint16_t* last = reinterpret_cast<const uint16_t*>(sr.buf + s_k);
    for (int j = t; j < H; j += T) dst[j] = src[last[j]];
    batches.end();                    // the next group's rows
    __syncthreads();
    uint16_t* tmp = src;
    src = dst;
    dst = tmp;
    sb = sr.advance(s_k);
    rb = yr.advance(r_k);
    prev_rows = rows;
  }
  const int64_t g_last = (n - 1) / GS;
  const uint8_t* st = stage + (g_last & 1) * GS * H;
  uint8_t* o = A + g_last * GS * H;
  for (int x = t; x < prev_rows * H; x += T) o[x] = st[x];
  cp_async_wait<0>();
}

// the chain past SMEM_H: perm in the scratch, rows from device memory, a
// row a barrier
template <bool WIDE>
__device__ __forceinline__ void chain_global(const uint8_t* __restrict__ Y,
                                             uint8_t* __restrict__ A,
                                             int64_t n, int H, const void* sig,
                                             int32_t* perm) {
  using Sig = typename std::conditional<WIDE, int32_t, uint16_t>::type;
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t Hp = WIDE ? (H + 3) & ~3 : (H + 7) & ~7;
  int32_t* src = perm;
  int32_t* dst = perm + H;
  for (int j = t; j < H; j += T) src[j] = j;
  __syncthreads();
  for (int64_t i = 0; i < n; i++) {
    const Sig* s = reinterpret_cast<const Sig*>(sig) + i * Hp;
    for (int j = t; j < H; j += T) {
      const int32_t p = src[j];
      dst[j] = src[s[j]];
      A[i * H + p] = Y[i * H + j];
    }
    __syncthreads();
    int32_t* tmp = src;
    src = dst;
    dst = tmp;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
chain_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             const int64_t* __restrict__ meta, int32_t* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t* m = meta + (int64_t)blockIdx.x * META;
  const int64_t off = m[0], n = m[1];
  const int H = (int)m[2];
  if (n == 0 || H == 0) return;
  int32_t* sig = work + m[3];
  if (H <= SMEM_H) {
    chain_smem(in + off, out + off, n, H,
               reinterpret_cast<const uint16_t*>(sig), smem_raw);
    return;
  }
  const int64_t words = H <= U16_H ? n * (((H + 7) & ~7) / 2)
                                   : n * ((H + 3) & ~3);
  if (H <= U16_H) chain_global<false>(in + off, out + off, n, H, sig,
                                      sig + words);
  else chain_global<true>(in + off, out + off, n, H, sig, sig + words);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the sorts need a sorting warp and the helper
bool bad_threads(int threads) {
  return threads < 64 || threads > MAX_THREADS || threads % 32;
}

int launch_sigmas(const void* in, const void* meta, int R, int threads,
                  void* work, cudaStream_t st) {
  const int smem = SIGMA_SMEM;
  const cudaError_t e = allow_smem(sigma_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((SIGMA_BLOCKS + R - 1) / R, R);
  sigma_kernel<<<grid, threads, smem, st>>>(
      (const uint8_t*)in, (const int64_t*)meta, (int32_t*)work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// R matrices: in and out hold them (n x H bytes each, row-major, at the
// same offsets); meta R rows of (offset, n, H, offset in int32 words of
// the matrix's scratch, a multiple of 4: pbwt_torch.prepare's layout).
// threads: a multiple of 32 in [32, 1024], with a warp's segment,
// ceil(H / threads) x 32 values, at most 65,535 (its counts are u16).
// Returns the CUDA error of the launch.
int pbwt_encode(const void* in, void* out, const void* meta, int R,
                int threads, void* work, void* stream) {
  if (R <= 0) return 0;
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(encode_kernel, ENC_SMEM);
  if (e != cudaSuccess) return (int)e;
  encode_kernel<<<R, threads, ENC_SMEM, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int64_t*)meta,
      (int32_t*)work);
  return (int)cudaGetLastError();
}

// phase 1 of pbwt_decode alone: every row's sigma into the scratch
int pbwt_sigmas(const void* in, const void* meta, int R, int threads,
                void* work, void* stream) {
  if (R <= 0) return 0;
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  return launch_sigmas(in, meta, R, threads, work, (cudaStream_t)stream);
}

// both phases, two launches on `stream`
int pbwt_decode(const void* in, void* out, const void* meta, int R,
                int threads, void* work, void* stream) {
  if (R <= 0) return 0;
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = launch_sigmas(in, meta, R, threads, work, st);
  if (rc) return rc;
  const cudaError_t e = allow_smem(chain_kernel, CHAIN_SMEM);
  if (e != cudaSuccess) return (int)e;
  chain_kernel<<<R, threads, CHAIN_SMEM, st>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int64_t*)meta,
      (int32_t*)work);
  return (int)cudaGetLastError();
}

}  // extern "C"

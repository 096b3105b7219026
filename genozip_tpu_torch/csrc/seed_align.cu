// Seed-hash read aligner: one hand-written Hopper kernel (sm_90a).
//
// The function is genozip_tpu's mesh aligner step,
// genozip_tpu/parallel/aligner_sharded.py make_sharded_aligner's `local`
// (:65-140), an XLA device function under shard_map; it has no Pallas
// kernel. The port keeps the whole genome and layer 0 of the refhash on each
// card (an 80 GB card holds a human genome), so this is `local` at mp = 1:
// every candidate's window lies in the one slab, and no count is summed
// over ranks (the sharded version adds two ranks' counts near a slab
// boundary, fault F16). The plain version is ops/align_torch.seed_align_plain;
// the two agree exactly.
//
// For each read r (a row of codes, lens[r] bases, padded to Lb columns):
// two directions in order, forward then the reverse complement (row
// clip(len-1-p, 0, Lb-1) xor 3); in each, 4 seeds at
// off = clip(floor((len-16)*si/3), 0, max(len-16, 0)); the seed's 16-base
// k-mer read from the row at clip(off+j, 0, Lb-1), packed as
// km = (km << 2) | code (u32); slot h = (km * 2654435761 mod 2^32) >>
// (32 - hash_bits); g = rh[h] (0xFFFFFFFF: no entry); the candidate start
// = g - off in u32, kept when g is an entry, off <= g, start <= G - len
// (u32) and len <= G; its mismatch count over p < min(len, Lb) against
// genome[start + p]; the first strictly smaller count wins. Outputs: gpos
// (the u32 start, 0xFFFFFFFF if none), is_fwd, nmm (0 unless aligned) and
// aligned = nmm <= len/2 and gpos != 0xFFFFFFFF.
//
// What bounds it: bytes, about 1.76 kB a read of cfg4 (its code sectors,
// 8 refhash sectors and the distinct genome windows of 5-6 sectors each,
// chip_smoke.seed_align_traffic) against about 8 x 34 + 2 x 150 x 8 integer
// operations. All of it is data-dependent gathers with no reuse between
// reads, and a read is a chain of them: lens, then the row, then the 8
// refhash slots, then the windows. The first version walked the 8
// candidates one after another, a refhash load and 5-6 window loads each,
// so a read waited on about 20 DRAM round trips in a row.
//
// Design: one warp a read, 8 warps a block, a persistent grid (as many
// blocks as are resident, each warp striding over reads; 3 a SM at the 80
// registers the loop takes, which spills at 64). The warp keeps its read's
// codes in a row in shared memory, from 4-byte loads when the rows are
// 4-byte aligned, and builds the reverse-complement row beside it a word at
// a time (two row words, a funnel shift, a byte reversal, xor 3); each row
// takes round_up(Lb, 248) + 4 bytes, so Lb up to 16384 fits the 48 KB a
// block may take, with fewer warps a block past about 3000. All 8 seeds at
// once: lanes 0-15 build candidates 0, 2, 4, 6 and lanes 16-31 candidates
// 1, 3, 5, 7, one base a lane, and __reduce_or_sync folds each
// (shift-then-or distributes over or, so this equals the sequential fold
// bit for bit); lanes 0-7 then load the 8 refhash slots together, one round
// trip instead of eight. All windows at once: every lane loads two aligned
// genome words for each candidate (tiles of 248 bases, two halves of 31
// words), all 16 loads in flight together, and lanes 0-30 take the 4 bases
// they compare from their word and the next lane's (__shfl_down_sync,
// __funnelshift_r). No word past the genome's last whole word is loaded:
// the partial last word is read byte by byte once, at the start. Unequal
// bytes are counted 4 a step (the carry of (x & 0x7f7f7f7f) + 0x7f7f7f7f
// flags a nonzero byte of x = genome ^ row, then __popc), two candidates'
// counts a register, summed over the warp (__reduce_add_sync), and the
// winner is the minimum of (count << 3) | c over usable candidates c: the
// smallest count, ties to the lowest index, which is the sequential rule.
// While a read's windows are in flight the warp loads the next read's
// length and first 256 code bytes. Longer windows loop over tiles.

#include <cstdint>
#include <cuda_runtime.h>

#include "persistent.cuh"

namespace {

constexpr int KMER = 16;
constexpr int NUM_SEEDS = 4;
constexpr int NCAND = 2 * NUM_SEEDS;
constexpr uint32_t FIB32 = 2654435761u;
constexpr uint32_t NO_GPOS = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 8;             // reads in flight a block
// window bases a tile: lanes 0-30 compare 4 bases each from their word and
// the next lane's, in two halves of 31 words (lane 31 loads the last
// neighbour of a half and compares nothing)
constexpr int HALF = 124;
constexpr int TILE = 2 * HALF;
constexpr int PRE = 2;                   // code words a lane prefetches
constexpr int MAX_LB = 16384;            // two rows of one warp in 48 KB

// bytes of one staged row: whole tiles and the 4 bytes lane 31 reads past
__host__ __device__ constexpr int row_bytes(int Lb) {
  return ((Lb + TILE - 1) / TILE * TILE + 4 + 15) / 16 * 16;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// row bytes q .. q+3 (q a multiple of 4); 0 from `extent` on, not read
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int q,
                                             int extent, bool aligned) {
  if (q >= extent) return 0;
  if (aligned) return __ldg(reinterpret_cast<const uint32_t*>(row + q));
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    if (q + k < extent) v |= (uint32_t)__ldg(row + q + k) << (8 * k);
  return v;
}

// the count of unequal bytes of g and r within `mask` (0x80 in each byte
// to count): a byte of g ^ r is nonzero when its low 7 bits carry into bit
// 7 or bit 7 is set
__device__ __forceinline__ int unequal_bytes(uint32_t g, uint32_t r,
                                             uint32_t mask) {
  const uint32_t x = g ^ r;
  return __popc((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & mask);
}

// 0x80 in each of the first n bytes (n <= 0: none)
__device__ __forceinline__ uint32_t count_mask(int n) {
  return n >= 4 ? 0x80808080u : n <= 0 ? 0u : 0x80808080u >> (8 * (4 - n));
}

struct Tile {
  uint32_t a[NCAND], b[NCAND];   // window words of lane and lane + 31
};

// the words of every candidate's window that tile P needs: word w of the
// genome is loaded when w < lim (lim: the window's end, at most the
// genome's last whole word); the last, partial word of the genome is
// `tail`, and a word not loaded keeps it, its bytes all past the window
__device__ __forceinline__ void load_tile(Tile& t, const uint32_t* genome_w,
                                          const uint32_t (&st)[NCAND],
                                          const uint32_t (&lim)[NCAND],
                                          uint32_t tail, int P, int lane) {
#pragma unroll
  for (int c = 0; c < NCAND; ++c) {
    const uint32_t w = (st[c] >> 2) + (uint32_t)(P / 4 + lane);
    t.a[c] = t.b[c] = tail;
    if (w < lim[c]) t.a[c] = __ldg(genome_w + w);
    if (w + HALF / 4 < lim[c]) t.b[c] = __ldg(genome_w + w + HALF / 4);
  }
}

// adds tile P's mismatch counts, candidates 2i and 2i+1 in the low and
// high half of acc[i]
__device__ __forceinline__ void count_tile(const Tile& t,
                                           const uint32_t (&st)[NCAND],
                                           const uint32_t* fwd_w,
                                           const uint32_t* rev_w, int span,
                                           int P, int lane,
                                           uint32_t (&acc)[NUM_SEEDS]) {
  const int qa = P + 4 * lane, qb = qa + HALF;
  const uint32_t ma = lane < 31 ? count_mask(span - qa) : 0u;
  const uint32_t mb = lane < 31 ? count_mask(span - qb) : 0u;
  const uint32_t fa = fwd_w[qa >> 2], fb = fwd_w[qb >> 2];
  const uint32_t ra = rev_w[qa >> 2], rb = rev_w[qb >> 2];
#pragma unroll
  for (int c = 0; c < NCAND; ++c) {
    const uint32_t na = __shfl_down_sync(FULL, t.a[c], 1);
    const uint32_t nb = __shfl_down_sync(FULL, t.b[c], 1);
    const uint32_t sh = 8 * (st[c] & 3);   // the start's byte in its word
    const uint32_t ga = __funnelshift_r(t.a[c], na, sh);
    const uint32_t gb = __funnelshift_r(t.b[c], nb, sh);
    const int n = unequal_bytes(ga, c < NUM_SEEDS ? fa : ra, ma) +
                  unequal_bytes(gb, c < NUM_SEEDS ? fb : rb, mb);
    acc[c >> 1] += (uint32_t)n << (16 * (c & 1));
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 3)
seed_align_kernel(const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ lens, long long R, int Lb,
                  int Lbp, bool aligned, const uint8_t* __restrict__ genome,
                  const uint32_t* __restrict__ rh, uint32_t G, int hash_bits,
                  long long* __restrict__ gpos_out,
                  uint8_t* __restrict__ fwd_out,
                  int32_t* __restrict__ nmm_out,
                  uint8_t* __restrict__ aligned_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  uint8_t* fwd = smem + (size_t)(threadIdx.x >> 5) * 2 * Lbp;
  uint8_t* rev = fwd + Lbp;
  uint32_t* fwd_w = reinterpret_cast<uint32_t*>(fwd);
  uint32_t* rev_w = reinterpret_cast<uint32_t*>(rev);
  const uint32_t* genome_w = reinterpret_cast<const uint32_t*>(genome);
  const long long step = (long long)gridDim.x * wpb;
  const int shift = 32 - hash_bits;
  const int half = lane >> 4, j = lane & 15;   // k-mer lanes
  const uint32_t whole = G >> 2;               // whole words of the genome
  uint32_t tail = 0;                           // the partial last word
  for (uint32_t k = 0; 4 * whole + k < G; ++k)
    tail |= (uint32_t)__ldg(genome + 4 * whole + k) << (8 * k);
  long long r = (long long)blockIdx.x * wpb + (threadIdx.x >> 5);
  int len_n = r < R ? __ldg(lens + r) : 0;
  uint32_t pre[PRE];
#pragma unroll
  for (int k = 0; k < PRE; ++k)
    pre[k] = r < R ? row_word(codes + r * Lb, 4 * lane + 128 * k,
                              min(max(len_n, KMER), Lb), aligned) : 0;
  for (; r < R; r += step) {
    const int len = len_n;
    const int span = min(len, Lb);                // positions compared
    const int extent = min(max(len, KMER), Lb);   // row bytes read
    const long long rn = r + step;
    len_n = rn < R ? __ldg(lens + rn) : 0;
    __syncwarp();                      // the last read's rows are done with
#pragma unroll
    for (int k = 0; k < PRE; ++k) {
      const int q = 4 * lane + 128 * k;
      if (q < extent) fwd_w[q >> 2] = pre[k];
    }
    for (int q = 4 * lane + 128 * PRE; q < extent; q += 128)
      fwd_w[q >> 2] = row_word(codes + r * Lb, q, extent, aligned);
    __syncwarp();
    if (len >= KMER && len <= Lb) {
      // rev word q: fwd bytes len-4-q .. len-1-q, reversed (bytes of rev
      // at len and past, never read, take what the shift brings)
      for (int q = 4 * lane; q < len; q += 128) {
        const int e = len - 4 - q, a = e >> 2;   // e >= -3
        const uint32_t src = __funnelshift_r(fwd_w[max(a, 0)], fwd_w[a + 1],
                                             8 * (e & 3));
        rev_w[q >> 2] = __byte_perm(src, 0, 0x0123) ^ 0x03030303u;
      }
    } else {
      for (int q = lane; q < extent; q += 32)
        rev[q] = fwd[clampi(len - 1 - q, 0, Lb - 1)] ^ 3;
    }
    __syncwarp();

    // seed offsets: floor((len - 16) * si / 3), clipped to [0, len - 16]
    const uint32_t d = (uint32_t)max(len - KMER, 0);
    const uint32_t off1 = d / 3, off2 = 2 * d / 3;
    // the 8 k-mers: candidate c = 2i + half, direction c >> 2, seed c & 3
    const int pa = clampi((int)(half ? off1 : 0u) + j, 0, Lb - 1);
    const int pb = clampi((int)(half ? d : off2) + j, 0, Lb - 1);
    const int sl = 2 * (KMER - 1 - j);
    const uint32_t part[NUM_SEEDS] = {
        (uint32_t)fwd[pa] << sl, (uint32_t)fwd[pb] << sl,
        (uint32_t)rev[pa] << sl, (uint32_t)rev[pb] << sl};
    uint32_t mykm = 0;
#pragma unroll
    for (int i = 0; i < NUM_SEEDS; ++i) {
      const uint32_t lo = __reduce_or_sync(FULL, half ? 0u : part[i]);
      const uint32_t hi = __reduce_or_sync(FULL, half ? part[i] : 0u);
      if (lane == 2 * i) mykm = lo;
      if (lane == 2 * i + 1) mykm = hi;
    }
    // lane c < 8: candidate c's refhash slot, start and guards
    uint32_t g = NO_GPOS;
    if (lane < NCAND) {
      const uint32_t prod = mykm * FIB32;
      g = __ldg(rh + (shift > 0 ? prod >> shift : prod));
    }
    const uint32_t offu = lane & 2 ? (lane & 1 ? d : off2)
                                   : (lane & 1 ? off1 : 0u);
    const uint32_t lu = (uint32_t)len;
    const uint32_t start = g - offu;   // wraps only when off > g
    const bool ok = lane < NCAND &&
        !(g == NO_GPOS || offu > g || start > G - lu || lu > G);
    const unsigned okm = __ballot_sync(FULL, ok) & ((1u << NCAND) - 1);
    // each candidate's start and load limit, to all lanes: the window's
    // words end at ceil((start + span) / 4), and no word past the genome's
    // last whole one is loaded (an unusable candidate loads nothing)
    const uint32_t lim_c =
        ok ? min((uint32_t)(((uint64_t)start + max(span, 0) + 3) >> 2), whole)
           : 0u;
    uint32_t lim[NCAND], st[NCAND];
#pragma unroll
    for (int c = 0; c < NCAND; ++c) {
      st[c] = __shfl_sync(FULL, start, c);
      lim[c] = __shfl_sync(FULL, lim_c, c);
    }

    // the windows: tile 0's loads all in flight, then the next read's row
    uint32_t acc[NUM_SEEDS] = {0, 0, 0, 0};
    Tile t;
    load_tile(t, genome_w, st, lim, tail, 0, lane);
#pragma unroll
    for (int k = 0; k < PRE; ++k)
      pre[k] = rn < R ? row_word(codes + rn * Lb, 4 * lane + 128 * k,
                                 min(max(len_n, KMER), Lb), aligned) : 0;
    count_tile(t, st, fwd_w, rev_w, span, 0, lane, acc);
    for (int P = TILE; P < span; P += TILE) {   // reads past 248 bases
      load_tile(t, genome_w, st, lim, tail, P, lane);
      count_tile(t, st, fwd_w, rev_w, span, P, lane, acc);
    }
    // the smallest (count << 3) | c: smallest count, ties to the first
    unsigned best = FULL;
#pragma unroll
    for (int i = 0; i < NUM_SEEDS; ++i) {
      const uint32_t both = __reduce_add_sync(FULL, acc[i]);
      if (okm >> (2 * i) & 1)
        best = min(best, ((both & 0xffffu) << 3) | (unsigned)(2 * i));
      if (okm >> (2 * i + 1) & 1)
        best = min(best, ((both >> 16) << 3) | (unsigned)(2 * i + 1));
    }
    if (lane == 0) {
      uint32_t gp = NO_GPOS;
#pragma unroll
      for (int c = 0; c < NCAND; ++c)
        if (best != FULL && (best & 7) == (unsigned)c) gp = st[c];
      const int nmm = (int)(best >> 3);
      const bool al = best != FULL && nmm <= len / 2 && gp != NO_GPOS;
      gpos_out[r] = (long long)gp;
      fwd_out[r] = best == FULL || (best & 7) < NUM_SEEDS ? 1 : 0;
      nmm_out[r] = al ? nmm : 0;
      aligned_out[r] = al ? 1 : 0;
    }
  }
}

}  // namespace

// R reads of Lb padded code columns (Lb <= 16384) against a genome of G
// codes (4-byte aligned) and a refhash layer of 2^hash_bits u32 slots; one
// launch on `stream`. Returns cudaGetLastError() after the launch (0:
// launched), or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int seed_align(const void* codes, const void* lens, long long R,
                          int Lb, const void* genome, const void* rh,
                          unsigned int G, int hash_bits, void* gpos,
                          void* is_fwd, void* nmm, void* aligned,
                          void* stream) {
  if (R <= 0) return 0;
  if (Lb <= 0 || Lb > MAX_LB || hash_bits < 1 || hash_bits > 32 ||
      ((uintptr_t)genome & 3))
    return (int)cudaErrorInvalidValue;
  const int Lbp = row_bytes(Lb);
  const int wpb = min(MAX_WARPS, 48 * 1024 / (2 * Lbp));
  const size_t smem = (size_t)wpb * 2 * Lbp;
  const bool rows_aligned = ((uintptr_t)codes & 3) == 0 && (Lb & 3) == 0;
  long long blocks = (R + wpb - 1) / wpb;
  // the persistent grid's size, one launch shape for each row size
  static int resident[persistent::MAX_DEVICES][row_bytes(MAX_LB) / TILE + 1];
  const int most = persistent::resident_blocks(resident, Lbp / TILE,
                                               seed_align_kernel, 32 * wpb,
                                               smem);
  if (blocks > most) blocks = most;
  seed_align_kernel<<<(unsigned)blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lens, R, Lb, Lbp, rows_aligned,
      (const uint8_t*)genome, (const uint32_t*)rh, (uint32_t)G, hash_bits,
      (long long*)gpos, (uint8_t*)is_fwd, (int32_t*)nmm, (uint8_t*)aligned);
  return (int)cudaGetLastError();
}

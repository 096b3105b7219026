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
// Design: one warp a read, eight reads a block of 256 threads, a
// grid-stride loop over reads. Lanes 0-15 each read one base of the seed
// and shift it into place; __reduce_or_sync folds the 16 parts into the
// k-mer (shift-then-or distributes over or, so this equals the sequential
// fold bit for bit). Every lane loads the refhash slot (one address: one
// transaction). The window compare runs 32 bases at a time, one a lane,
// and __popc(__ballot_sync(...)) counts the warp's mismatches. Every
// branch depends only on the read and the candidate, so it is uniform over
// the warp and the full-mask intrinsics are safe; lane 0 keeps the best
// candidate and writes the outputs.
//
// What bounds it: bytes. A read of cfg4 (150 bp, Lb = 256) moves its 256
// code bytes, 4 of lens, 8 refhash sectors of 32 B and up to 8 genome
// windows of 5-6 sectors: about 2.1 kB, against about 8 x (34 + 2 x 150)
// integer operations. The refhash and genome reads are data-dependent
// gathers, one sector each, with no reuse between reads to exploit in
// shared memory; making it fast (several reads' seeds in flight a warp)
// is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMER = 16;
constexpr int NUM_SEEDS = 4;
constexpr uint32_t FIB32 = 2654435761u;
constexpr uint32_t NO_GPOS = 0xFFFFFFFFu;
constexpr int NT = 256;                  // threads a block: 8 reads
constexpr int MAX_BLOCKS = 132 * 16;     // a grid-stride loop past this
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// floor(a / 3) for any sign (jnp's // floors; C's / truncates)
__device__ __forceinline__ int floor_div3(int a) {
  return a >= 0 ? a / 3 : -((-a + 2) / 3);
}

__global__ void __launch_bounds__(NT)
seed_align_kernel(const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ lens, long long R, int Lb,
                  const uint8_t* __restrict__ genome,
                  const uint32_t* __restrict__ rh, uint32_t G, int hash_bits,
                  long long* __restrict__ gpos_out,
                  uint8_t* __restrict__ fwd_out,
                  int32_t* __restrict__ nmm_out,
                  uint8_t* __restrict__ aligned_out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (NT / 32);
  const int shift = 32 - hash_bits;
  for (long long r = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
       r < R; r += warps) {
    const uint8_t* row = codes + r * Lb;
    const int len = lens[r];
    const int span = min(len, Lb);        // positions compared
    int best_nmm = 1 << 30;
    uint32_t best_gpos = NO_GPOS;
    bool best_fwd = true;
    for (int dir = 0; dir < 2; ++dir) {   // 0: forward, 1: revcomp
      for (int si = 0; si < NUM_SEEDS; ++si) {
        const int off = clampi(floor_div3((len - KMER) * si), 0,
                               max(len - KMER, 0));
        uint32_t part = 0;
        if (lane < KMER) {
          const int p = clampi(off + lane, 0, Lb - 1);
          const uint32_t v = dir == 0
              ? (uint32_t)row[p]
              : (uint32_t)(row[clampi(len - 1 - p, 0, Lb - 1)] ^ 3);
          part = v << (2 * (KMER - 1 - lane));
        }
        const uint32_t km = __reduce_or_sync(FULL, part);
        const uint32_t prod = km * FIB32;
        const uint32_t h = shift > 0 ? prod >> shift : prod;
        const uint32_t g = rh[h];
        const uint32_t offu = (uint32_t)off, lu = (uint32_t)len;
        const uint32_t start = g - offu;   // wraps only when off > g
        if (g == NO_GPOS || offu > g || start > G - lu || lu > G) continue;
        int mm = 0;
        for (int base = 0; base < span; base += 32) {
          const int p = base + lane;
          bool diff = false;
          if (p < span) {
            const uint32_t rv = dir == 0
                ? (uint32_t)row[p]
                : (uint32_t)(row[clampi(len - 1 - p, 0, Lb - 1)] ^ 3);
            diff = (uint32_t)genome[(size_t)start + p] != rv;
          }
          mm += __popc(__ballot_sync(FULL, diff));
        }
        if (mm < best_nmm) {
          best_nmm = mm;
          best_gpos = start;
          best_fwd = dir == 0;
        }
      }
    }
    if (lane == 0) {
      const bool al = best_nmm <= len / 2 && best_gpos != NO_GPOS;
      gpos_out[r] = (long long)best_gpos;
      fwd_out[r] = best_fwd ? 1 : 0;
      nmm_out[r] = al ? best_nmm : 0;
      aligned_out[r] = al ? 1 : 0;
    }
  }
}

}  // namespace

// R reads of Lb padded code columns against a genome of G codes and a
// refhash layer of 2^hash_bits u32 slots; one launch on `stream`. Returns
// cudaGetLastError() after the launch (0: launched).
extern "C" int seed_align(const void* codes, const void* lens, long long R,
                          int Lb, const void* genome, const void* rh,
                          unsigned int G, int hash_bits, void* gpos,
                          void* is_fwd, void* nmm, void* aligned,
                          void* stream) {
  if (R <= 0) return 0;
  if (Lb <= 0 || hash_bits < 1 || hash_bits > 32) return (int)cudaErrorInvalidValue;
  long long blocks = (R + NT / 32 - 1) / (NT / 32);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  seed_align_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lens, R, Lb,
      (const uint8_t*)genome, (const uint32_t*)rh, (uint32_t)G, hash_bits,
      (long long*)gpos, (uint8_t*)is_fwd, (int32_t*)nmm, (uint8_t*)aligned);
  return (int)cudaGetLastError();
}

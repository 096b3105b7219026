// The PBWT kernels' shared pieces: the constants, the row ring, and the
// steps of a row's stable counting sort by one block (code table, warp
// ranks, counts, place) on its tables in shared memory. csrc/pbwt.cu's
// kernels and the row floors of csrc/devfns_micro.cu are built from them;
// see pbwt.cu for the design.
//
// A row's sort works on codes, not values: a value's code is the number of
// present values below it (np codes for np present values), so the ranks
// take ceil(log2 np) ballots a step (1 for a biallelic row, 2 for a GT row
// with missing calls, 4 for 0..10) and, up to 32 codes, a warp's running
// counts live in registers, lane c holding code c's (past 32 codes,
// __match_any_sync and counts in shared memory); up to 16 codes the
// first destinations come from warp reductions into registers too. A block is nw sorting
// warps and one helper warp (warp nw): while row i is sorted, row i + 1's
// values are flagged (by the helper from the encoder's ring up to
// HELPER_FLAGS_H values, else by the sorting warps), and after barrier 1
// the helper builds row i + 1's code table from the flags and clears row
// i's, so a row starts with its codes and the table is not on the sorting
// warps' path.
//
// The sort's tables, for nw sorting warps (table_bytes: 64,528 bytes at
// 31, 15,376 at 7):
//   flags[2][256] u8: each value's presence, one buffer a row parity;
//   ctab[2][256] u8 and np[2]: the code table, one a row parity;
//   cnt[256][nw | 1] int32: each warp's count of each code (an odd stride,
//     so a lane a code reads its column without bank conflicts);
//   wdst[nw][256] int32: each warp's first destination of each code.
// The counts and destinations of codes below np are written whole every
// row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pbwtk {

constexpr int MAX_THREADS = 1024;
constexpr int SMEM_H = 12288;   // perm, rings and stage in shared memory
constexpr int STEPS = 16;       // a warp's steps kept in registers, at most
constexpr int HELPER_FLAGS_H = 2048;   // the helper flags rows up to this H
constexpr int RING_BYTES = 4 * SMEM_H + 32;   // a row ring, at least
constexpr int U16_H = 65535;    // sort orders as u16 up to this H
constexpr int META = 4;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int table_bytes(int nw) {
  return 1040 + 256 * (nw | 1) * 4 + nw * 1024;
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1;
}

struct Tables {
  uint8_t* flags;
  uint8_t* ctab;
  int* np;
  int* cnt;
  int* wdst;
  int nw, stride;

  // carved from 16-byte aligned shared memory for nw sorting warps, the
  // flags zeroed (the caller's next barrier publishes them)
  __device__ void carve(unsigned char* base, int warps) {
    nw = warps;
    stride = nw | 1;
    flags = base;
    ctab = base + 512;
    np = reinterpret_cast<int*>(base + 1024);
    cnt = reinterpret_cast<int*>(base + 1040);
    wdst = cnt + 256 * stride;
    for (int i = threadIdx.x; i < 128; i += blockDim.x)
      reinterpret_cast<uint32_t*>(flags)[i] = 0;
  }
  __device__ uint8_t* row_flags(int64_t i) const {
    return flags + (i & 1) * 256;
  }
  __device__ uint8_t* row_codes(int64_t i) const {
    return ctab + (i & 1) * 256;
  }
};

// The helper warp's code table of a row from its flags (0 or 1 a value):
// lane l takes the values 8 l .. 8 l + 7; a value's code counts the
// present values of the lanes below (8 ballots, one a byte of the lanes'
// flags) and those below it in its own lane. Returns np, the number of
// present values.
__device__ __forceinline__ int code_table(const uint8_t* flags,
                                          uint8_t* ctab_w) {
  const int lane = threadIdx.x & 31;
  const uint2 q = reinterpret_cast<const uint2*>(flags)[lane];
  const uint32_t b = (q.x & 1) | ((q.x >> 7) & 2) | ((q.x >> 14) & 4) |
                     ((q.x >> 21) & 8) | ((q.y & 1) << 4) |
                     ((q.y >> 3) & 0x20) | ((q.y >> 10) & 0x40) |
                     ((q.y >> 17) & 0x80);
  int below = 0, np = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const unsigned m = __ballot_sync(FULL, (b >> k) & 1);
    below += __popc(m & lanemask_lt());
    np += __popc(m);
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    lo |= (uint32_t)(below + __popc(b & ((1u << k) - 1))) << (8 * k);
    hi |= (uint32_t)(below + __popc(b & ((1u << (k + 4)) - 1))) << (8 * k);
  }
  reinterpret_cast<uint2*>(ctab_w)[lane] = make_uint2(lo, hi);
  return np;
}

// The helper warp's row i: barrier 1 (the sorting warps have flagged row
// i + 1's values), row i + 1's code table, row i's flags cleared (read
// for its table a row ago); the caller's barrier 2 publishes them.
__device__ __forceinline__ void helper_row(const Tables& tb, int64_t i,
                                           bool next) {
  __syncthreads();                                     // barrier 1
  const int lane = threadIdx.x & 31;
  reinterpret_cast<uint2*>(tb.row_flags(i))[lane] = make_uint2(0u, 0u);
  if (next) {
    const int np = code_table(tb.row_flags(i + 1), tb.row_codes(i + 1));
    if (lane == 0) tb.np[(i + 1) & 1] = np;
  }
}

// The ranks of a warp's steps by the codes of np present values; step()
// returns the lane's position among the warp's equal codes so far, from
// the counts' starting values (zero for the counts, a destination for a
// scatter).
// NB > 0 (np <= 2^NB <= 32): NB ballots of the codes' bits a step
// (predicated past ceil(log2 np), no branch), the rank a __popc, and lane
// c keeps the running count of code c in `run`: the only chain from step
// to step is one add.
// NB = 0: __match_any_sync on the code, and the lowest lane of each code
// adds to the code's running count in shared memory (`col`, entries
// `stride` apart; only this warp touches them), a __syncwarp ordering
// each step's store before the next step's load.
template <int NB>
struct Rank {
  uint32_t run;
  int* col;
  int stride, nbits;

  // from zero (counts into col) or from col's values (cursors)
  __device__ void init(int np, int* c, int s, bool from_col) {
    const int lane = threadIdx.x & 31;
    col = c;
    stride = s;
    nbits = np > 1 ? 32 - __clz(np - 1) : 0;
    run = 0;
    if (NB && from_col && lane < np) run = (uint32_t)col[lane * stride];
    if (!NB && !from_col)
      for (int k = lane; k < np; k += 32) col[k * stride] = 0;
    __syncwarp();
  }
  __device__ int step(int code, bool valid) {
    const int lane = threadIdx.x & 31;
    if constexpr (NB > 0) {
      const unsigned live = __ballot_sync(FULL, valid);
      unsigned mine = live, cnt = live;
#pragma unroll
      for (int k = 0; k < NB; k++) {
        const bool on = k < nbits;
        const unsigned plane =
            __ballot_sync(FULL, on && valid && ((code >> k) & 1));
        const unsigned keep_all = on ? 0u : FULL;
        mine &= ((code >> k) & 1 ? plane : ~plane) | keep_all;
        cnt &= ((lane >> k) & 1 ? plane : ~plane) | keep_all;
      }
      const uint32_t before = __shfl_sync(FULL, run, code & 31);
      run += __popc(cnt);
      return (int)before + __popc(mine & lanemask_lt());
    } else {
      const unsigned peers = __match_any_sync(FULL, valid ? code : -1);
      const int lead = __ffs(peers) - 1;
      int old = 0;
      if (lane == lead && valid) {
        old = col[code * stride];
        col[code * stride] = old + __popc(peers);
      }
      old = __shfl_sync(FULL, old, lead);
      __syncwarp();
      return old + __popc(peers & lanemask_lt());
    }
  }
  // the counts into col (NB > 0 keeps them in registers until now)
  __device__ void store(int np) const {
    if (NB && (int)(threadIdx.x & 31) < np)
      col[(threadIdx.x & 31) * stride] = (int)run;
  }
};

// After barrier 1: warp w's first destination in the sorted row of each
// code, into wdst_w: the codes in groups of 32 (a lane a code), each
// code's total over the warps and warp w's column prefix (the counts of
// the warps before it), the totals' exclusive scan by shuffles (ceil(log2
// np) levels), carried from group to group. Its work grows with np, not
// with 256.
__device__ __forceinline__ void place(const Tables& tb, int np,
                                      int* wdst_w) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int carry = 0;
  for (int g = 0; g < np; g += 32) {
    const int c = g + lane, span = np - g < 32 ? np - g : 32;
    int tot = 0, before = 0;
    if (c < np) {
      const int* col = tb.cnt + c * tb.stride;
#pragma unroll 4
      for (int k = 0; k < tb.nw; k++) {
        const int x = col[k];
        before += k < w ? x : 0;
        tot += x;
      }
    }
    int incl = tot;
    for (int d = 1; d < span; d <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += x;
    }
    if (c < np) wdst_w[c] = carry + incl - tot + before;
    carry += __shfl_sync(FULL, incl, span - 1);
  }
  __syncwarp();
}

// After barrier 1, for up to MAXC codes: each code's total and this
// warp's column prefix by two warp reductions (a lane a warp, MAXC
// unrolled and predicated), carried from code to code; returns lane c's
// first destination of code c in the sorted row.
template <int MAXC>
__device__ __forceinline__ int firsts(const Tables& tb, int np) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int acc = 0, mine = 0;
#pragma unroll
  for (int c = 0; c < MAXC; c++) {
    const int x = c < np && lane < tb.nw ? tb.cnt[c * tb.stride + lane] : 0;
    const int tot = (int)__reduce_add_sync(FULL, (unsigned)x);
    const int before = (int)__reduce_add_sync(FULL, lane < w ? x : 0);
    if (lane == c) mine = acc + before;
    acc += tot;
  }
  return mine;
}

// One row's stable counting sort by the block's sorting warps (warp w <
// tb.nw, ns = 32 tb.nw threads), after its code table `codes`: the row's
// position j < H has a value and a payload (load(j, live, value,
// payload): called for every step, j clamped into the row so that no
// branch holds the loads back, and `live` false past the row, where the
// value must not be stored elsewhere); the sorted payloads go to
// put(destination, payload); pre() runs just before barrier 1 (the next
// row's flags). Warp w takes the contiguous segment of seg steps of 32
// positions from w seg 32. SEG > 0 (NB > 0 only): seg = SEG, a thread's
// codes, payloads and positions kept in registers from the ranks to the
// scatter (a step: code 8 bits, position 9, payload 15); SEG = 0: seg =
// ceil(H / ns), loaded and ranked again for the scatter. Ends after the
// scatter, before the caller's barrier 2.
template <int SEG, int NB, class Load, class Put, class Pre>
__device__ __forceinline__ void sort_row(const Tables& tb, int np,
                                         const uint8_t* codes, int H,
                                         Load load, Put put, Pre pre) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ns = 32 * tb.nw;
  const int seg = SEG ? SEG : (H + ns - 1) / ns;
  const int j0 = w * seg * 32 + lane;
  int* wdst_w = tb.wdst + w * 256;
  Rank<NB> r;
  r.init(np, tb.cnt + w, tb.stride, false);
  if constexpr (SEG > 0) {
    uint32_t kept[SEG];
#pragma unroll
    for (int k = 0; k < SEG; k++) {
      const int j = j0 + 32 * k;
      int v, pay;
      load(j < H ? j : H - 1, j < H, v, pay);
      kept[k] = (uint32_t)v | (uint32_t)pay << 17;
    }
#pragma unroll
    for (int k = 0; k < SEG; k++) {
      const uint32_t code = codes[kept[k] & 255];
      kept[k] = (kept[k] & ~255u) | code |
                (uint32_t)r.step(code, j0 + 32 * k < H) << 8;
    }
    pre();
    r.store(np);
    __syncthreads();                                   // barrier 1
    if constexpr (NB <= 4) {
      // up to 2^NB codes: lane c's first destination of code c
      const int first = firsts<1 << NB>(tb, np);
#pragma unroll
      for (int k = 0; k < SEG; k++) {
        const int d = __shfl_sync(FULL, first, kept[k] & 31);
        if (j0 + 32 * k < H)
          put(d + (int)((kept[k] >> 8) & 511), (int)(kept[k] >> 17));
      }
    } else {
      place(tb, np, wdst_w);
#pragma unroll
      for (int k = 0; k < SEG; k++)
        if (j0 + 32 * k < H)
          put(wdst_w[kept[k] & 255] + (int)((kept[k] >> 8) & 511),
              (int)(kept[k] >> 17));
    }
  } else {
    for (int k = 0; k < seg; k++) {
      const int j = j0 + 32 * k;
      int v, pay;
      load(j < H ? j : H - 1, j < H, v, pay);
      r.step(codes[v], j < H);
    }
    pre();
    r.store(np);
    __syncthreads();                                   // barrier 1
    place(tb, np, wdst_w);
    Rank<NB> cur;                         // the destinations as cursors
    cur.init(np, wdst_w, 1, true);
    for (int k = 0; k < seg; k++) {
      const int j = j0 + 32 * k;
      int v, pay;
      load(j < H ? j : H - 1, j < H, v, pay);
      const int d = cur.step(codes[v], j < H);
      if (j < H) put(d, pay);
    }
  }
}

// the steps a warp keeps in registers for a row of H positions over nw
// sorting warps: ceil(H / 32 nw) rounded up to a power of two up to
// STEPS (the warps' segments then cover 32 nw SEG >= H positions), or 0
// past STEPS
__host__ __device__ __forceinline__ int seg_class(int H, int nw) {
  const int s = (H + 32 * nw - 1) / (32 * nw);
  return s <= 1 ? 1 : s <= 2 ? 2 : s <= 4 ? 4 : s <= 8 ? 8 : s <= 16 ? 16 : 0;
}

template <int NB, class Load, class Put, class Pre>
__device__ __forceinline__ void sort_row_seg(const Tables& tb, int cls,
                                             int np, const uint8_t* codes,
                                             int H, Load load, Put put,
                                             Pre pre) {
  switch (cls) {
    case 1: return sort_row<1, NB>(tb, np, codes, H, load, put, pre);
    case 2: return sort_row<2, NB>(tb, np, codes, H, load, put, pre);
    case 4: return sort_row<4, NB>(tb, np, codes, H, load, put, pre);
    case 8: return sort_row<8, NB>(tb, np, codes, H, load, put, pre);
    case 16: return sort_row<16, NB>(tb, np, codes, H, load, put, pre);
    default: return sort_row<0, NB>(tb, np, codes, H, load, put, pre);
  }
}

// sort_row for np present codes and the class of SEG: 2 ballots a step up
// to 4 codes, 4 up to 16 (first destinations by warp reductions), 5 up to
// 32 (by place), __match_any_sync past 32 (two passes)
template <class Load, class Put, class Pre>
__device__ __forceinline__ void sort_row_any(const Tables& tb, int cls,
                                             int np, const uint8_t* codes,
                                             int H, Load load, Put put,
                                             Pre pre) {
  if (np > 32) return sort_row<0, 0>(tb, np, codes, H, load, put, pre);
  if (np > 16) return sort_row_seg<5>(tb, cls, np, codes, H, load, put, pre);
  if (np > 4) return sort_row_seg<4>(tb, cls, np, codes, H, load, put, pre);
  sort_row_seg<2>(tb, cls, np, codes, H, load, put, pre);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint32_t nbytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A stream of n rows of H bytes (a matrix, or the decoder's sort orders)
// in a ring of `cap` bytes of shared memory: stream byte x at ring
// coordinate x + delta (mod cap), delta the stream's offset in its aligned
// 16-byte piece, so whole aligned pieces are copied with cp.async (the last
// one zero-filled past the stream); only the bytes of the first piece,
// when it is not aligned, are loaded one by one. fetch(rows) copies the
// pieces whose first coordinate lies in the next `rows` rows, each thread
// some, as one commit group; the piece a row shares with the row before
// comes with that row.
struct Ring {
  uint8_t* buf;
  const uint8_t* base;   // the aligned piece holding the first byte
  int64_t end;           // delta + n H
  int64_t lo;            // the next piece to fetch (a coordinate)
  int64_t next;          // the first row not fetched
  int pos;               // lo's ring position
  int delta, H, cap;

  __device__ void init(uint8_t* b, int capacity, const uint8_t* a,
                       int64_t nbytes, int h) {
    buf = b;
    cap = capacity;
    delta = (int)((uintptr_t)a & 15);
    base = a - delta;
    end = delta + nbytes;
    H = h;
    lo = delta ? 16 : 0;
    pos = (int)lo;
    next = 0;
    const int t = threadIdx.x;
    if (delta && t < 16 && t >= delta && t < end) buf[t] = base[t];
  }
  __device__ void fetch(int rows) {
    next += rows;
    const int64_t last = (delta + next * H + 15) & ~(int64_t)15;
    const int64_t hi = last < end ? last : end;
    // a fetch spans at most a third of the ring: one wrap at most
    int q = pos + 16 * threadIdx.x;
    for (int64_t p = lo + 16 * threadIdx.x; p < hi;
         p += 16 * blockDim.x, q += 16 * blockDim.x) {
      const int64_t left = end - p;
      cp_async16(buf + (q >= cap ? q - cap : q), base + p,
                 (uint32_t)(left < 16 ? left : 16));
    }
    cp_async_commit();
    if (hi > lo) {
      pos += (int)(hi - lo);
      pos = pos >= cap ? pos - cap : pos;
      lo = hi;
    }
  }
  // byte x of the row whose first byte is at ring position rb; the next
  // row's position
  __device__ uint8_t at(int rb, int x) const {
    const int q = rb + x;
    return buf[q >= cap ? q - cap : q];
  }
  __device__ int advance(int rb) const {
    const int q = rb + H;
    return q >= cap ? q - cap : q;
  }
};

// Rows come into the rings in batches of K rows, one commit group a
// batch, two batches ahead of the row being read (`lead` rows after the
// row being sorted: the encoder flags row i + 1 while it sorts row i): a
// ring of cap bytes holds 3 K + lead rows of H bytes and 32 more. A batch
// is published at the barrier before its first row is read, its pieces'
// latency hidden behind at least K rows.
__device__ __forceinline__ int batch_rows(int cap, int H, int lead) {
  const int k = ((cap - 32) / H - lead) / 3;
  return k < 1 ? 1 : k > 32 ? 32 : k;
}

// The batch schedule, row by row (c = the row being sorted + lead):
// start() before the row's reads fetches batch c / K + 2 when c is a
// batch's first row (c > 0); end() before the row's last barrier waits
// for the batch that row c + 1 opens.
struct Batches {
  int K, phase;
  __device__ void init(int k, int lead) {
    K = k;
    phase = lead % k;
  }
  __device__ bool opens(int64_t c) const { return phase == 0 && c > 0; }
  __device__ void end() {
    if (phase == K - 1) cp_async_wait<1>();
    phase = phase + 1 == K ? 0 : phase + 1;
  }
};

}  // namespace pbwtk

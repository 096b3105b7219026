// AES-256-CTR keystream XOR: one hand-written Hopper kernel (sm_90a).
//
// The function is genozip_tpu's section encryption (genozip_tpu/crypt.py,
// its native route gxz_aes256_ctr, native/gxz_native.cpp:1244-1258): FIPS-197
// AES-256 of a 16-byte counter block, the block's 16 keystream bytes XOR-ed
// into the data, the counter taken as one 128-bit big-endian integer and
// incremented by one a block, mod 2^128. It has no TPU kernel:
// genozip_tpu runs it in host C++. The plain version is
// ops/aes_torch.aes256_ctr_plain, and the two are byte-equal.
//
// What bounds it: not the bytes (n read, n written: 2n / 3.35 TB/s, 0.04 ms
// at 64 MiB) but the table lookups: a 16-byte block takes 14 rounds of 16
// lookups, 224 shared-memory reads at random indices. The SM serves 32
// lanes' reads a clock only when they fall in 32 different banks; with the
// four T-tables of the first version (one copy each) a warp's random
// indices collide 3-4 ways, so each lookup took 3-4 clocks.
//
// Design: one T-table replicated over the banks (the replicated-table form
// in C. Tezcan, "Optimization of Advanced Encryption Standard on Graphics
// Processing Units", IEEE Access, 2021). T0[x] = (2s, s, s, 3s) for
// s = S[x] is stored 32 times, copy l of entry x at word 32 x + l (32 KB
// of static shared memory), and lane l reads only copy l, so it always
// hits bank l: a warp's 32 lookups take one clock whatever the indices.
// T1..T3 are T0 rotated by 8, 16 and 24 bits, one PRMT (__byte_perm) after
// the lookup, and the last round's S-box byte is byte 1 of T0[x], so no
// other table is held; the last round's PRMTs also put the keystream bytes
// in memory order, so no byte swap follows. Without conflicts the rounds
// are bound by the ALU pipe instead: a lookup costs one operation to take
// the byte out of the state and one to make its address. The address is
// base + x * stride with `stride` (128 bytes) passed as an argument, which
// compiles to one IMAD on the FMA pipe; a constant stride compiled to a
// shift, a merge and a LEA, all on the ALU pipe. Each block of threads
// builds T0 once (256 S-box reads, then 32 copies with 16-byte stores); the
// grid is persistent, as many blocks as are resident on the card
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), so the table is built
// once a block and not once a 256 counter blocks. Otherwise as before: one
// thread a counter block from counter0 + its index (a 128-bit add as two
// u64 with a carry), round keys by value in the launch's parameters
// (uniform reads), a 16-byte load and store of the data (the buffer is
// 16-byte aligned) and the last partial block byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "persistent.cuh"

namespace {

constexpr int NT = 256;        // threads a block
constexpr int COPIES = 32;     // T0 replicas: one a bank

struct RoundKeys {
  uint32_t w[60];              // the key schedule, big-endian words
};

__device__ const uint8_t SBOX[256] = {
0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16};

// __byte_perm selectors (tests/test_torch_crypt.py models them): rotations
// right by 8, 16 and 24 bits turn T0[x] into T1[x], T2[x], T3[x]
constexpr unsigned ROR8 = 0x0321, ROR16 = 0x1032, ROR24 = 0x2103;
// last round: byte 1 of T0[x] is S[x]; two lookups' S bytes into bytes 0-1,
// two into bytes 2-3, then the halves joined: the word in memory order
constexpr unsigned LO_PAIR = 0x0051, HI_PAIR = 0x5100, JOIN = 0x7610;

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// one word of shared memory at a 32-bit shared address
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__global__ void __launch_bounds__(NT, 4)
aes256_ctr_kernel(const RoundKeys rk, uint64_t ctr_hi, uint64_t ctr_lo,
                  uint8_t* __restrict__ data, int64_t n, uint32_t stride) {
  __shared__ __align__(16) uint32_t T[256 * COPIES];
  __shared__ uint32_t T0[256];
  static_assert(NT == 256, "one thread an S-box entry");
  {
    const uint32_t s = SBOX[threadIdx.x];
    const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1b)) & 0xff;
    // column (2s, s, s, 3s): row 0's byte through MixColumns
    T0[threadIdx.x] = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
  }
  __syncthreads();
  for (int w = 4 * threadIdx.x; w < 256 * COPIES; w += 4 * NT) {
    const uint32_t t = T0[w >> 5];
    *reinterpret_cast<uint4*>(&T[w]) = make_uint4(t, t, t, t);
  }
  __syncthreads();
  // copy `lane` of entry x at base + x * stride (stride: COPIES * 4 bytes,
  // an argument so that the address is one IMAD; see the note above)
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(T) +
                        4 * (threadIdx.x & (COPIES - 1));
  // the last round key in memory order
  const uint32_t l0 = bswap(rk.w[56]), l1 = bswap(rk.w[57]),
                 l2 = bswap(rk.w[58]), l3 = bswap(rk.w[59]);
  const int64_t nblk = (n + 15) >> 4;
  for (int64_t b = (int64_t)blockIdx.x * NT + threadIdx.x; b < nblk;
       b += (int64_t)gridDim.x * NT) {
    const uint64_t lo = ctr_lo + (uint64_t)b;
    const uint64_t hi = ctr_hi + (lo < ctr_lo ? 1 : 0);
    uint32_t s0 = (uint32_t)(hi >> 32) ^ rk.w[0];
    uint32_t s1 = (uint32_t)hi ^ rk.w[1];
    uint32_t s2 = (uint32_t)(lo >> 32) ^ rk.w[2];
    uint32_t s3 = (uint32_t)lo ^ rk.w[3];
#define LOOK(x) lds(base + (x) * stride)
#define B3(s) ((s) >> 24)
#define B2(s) __byte_perm((s), 0, 0x4442)
#define B1(s) __byte_perm((s), 0, 0x4441)
#define B0(s) ((s) & 0xff)
#define COL(a, b, c, d, k)                                                  \
  (LOOK(B3(a)) ^ __byte_perm(LOOK(B2(b)), 0, ROR8) ^                        \
   __byte_perm(LOOK(B1(c)), 0, ROR16) ^ __byte_perm(LOOK(B0(d)), 0, ROR24) ^ \
   (k))
#pragma unroll
    for (int r = 1; r < 14; r++) {
      const uint32_t t0 = COL(s0, s1, s2, s3, rk.w[4 * r]);
      const uint32_t t1 = COL(s1, s2, s3, s0, rk.w[4 * r + 1]);
      const uint32_t t2 = COL(s2, s3, s0, s1, rk.w[4 * r + 2]);
      const uint32_t t3 = COL(s3, s0, s1, s2, rk.w[4 * r + 3]);
      s0 = t0; s1 = t1; s2 = t2; s3 = t3;
    }
    // last round: SubBytes and ShiftRows without MixColumns, in memory order
#define LAST(a, b, c, d, k)                                                 \
  (__byte_perm(__byte_perm(LOOK(B3(a)), LOOK(B2(b)), LO_PAIR),              \
               __byte_perm(LOOK(B1(c)), LOOK(B0(d)), HI_PAIR), JOIN) ^ (k))
    const uint32_t k0 = LAST(s0, s1, s2, s3, l0);
    const uint32_t k1 = LAST(s1, s2, s3, s0, l1);
    const uint32_t k2 = LAST(s2, s3, s0, s1, l2);
    const uint32_t k3 = LAST(s3, s0, s1, s2, l3);
#undef LAST
#undef COL
#undef B0
#undef B1
#undef B2
#undef B3
#undef LOOK
    const int64_t off = b << 4;
    if (off + 16 <= n) {
      uint4* p = reinterpret_cast<uint4*>(data + off);
      uint4 v = *p;
      v.x ^= k0; v.y ^= k1; v.z ^= k2; v.w ^= k3;
      *p = v;
    } else {
      const uint32_t ks[4] = {k0, k1, k2, k3};
      for (int j = 0; off + j < n; j++)
        data[off + j] ^= (uint8_t)(ks[j >> 2] >> (8 * (j & 3)));
    }
  }
}

}  // namespace

extern "C" {

// rk: the 60 big-endian words of the AES-256 key schedule (host memory);
// ctr_hi, ctr_lo: counter0's bytes 0-7 and 8-15 as big-endian integers;
// data: n bytes on the device, 16-byte aligned, XOR-ed in place.
int aes256_ctr(const uint32_t* rk, unsigned long long ctr_hi,
               unsigned long long ctr_lo, void* data, long long n,
               void* stream) {
  if (n <= 0) return 0;
  RoundKeys keys;
  for (int i = 0; i < 60; i++) keys.w[i] = rk[i];
  const long long nblk = (n + 15) >> 4;
  const long long want = (nblk + NT - 1) / NT;
  static int resident[persistent::MAX_DEVICES][1];
  const int most = persistent::resident_blocks(resident, 0, aes256_ctr_kernel,
                                               NT, 0);
  const int grid = (int)(want < most ? want : most);
  aes256_ctr_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      keys, ctr_hi, ctr_lo, (uint8_t*)data, n, COPIES * 4);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Design: CTR blocks are independent, so one thread computes one block's
// keystream from counter0 + its block index (a 128-bit add done as two u64
// with a carry) and XORs it into its 16 data bytes with one 16-byte load and
// store (the buffer is 16-byte aligned; the last partial block goes byte by
// byte). The round keys (60 big-endian words, expanded on the host) travel
// by value in the launch's parameters, read with uniform indices. The rounds
// are the four-T-table form: each block of threads builds T0..T3 (the
// S-box times the MixColumns column, rotated) and the S-box in shared memory,
// 4.25 KB, so a round is 16 shared lookups, 16 XORs and a round key per
// column. A grid-stride loop over blocks, at most 16 blocks an SM.
//
// What bounds it: the bytes (n read, n written: 2n / 3.35 TB/s, 0.04 ms at
// 64 MiB) are far below its work, 14 rounds of 16 shared-memory lookups a
// 16-byte block (224 lookups, about 14 a byte), whose random indices
// conflict on the 32 banks. Speed is for a later change (bit-sliced rounds,
// or T-tables replicated over banks).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;              // threads a block
constexpr int MAX_BLOCKS = 132 * 16;  // a grid-stride loop past this

struct RoundKeys {
  uint32_t w[60];                    // the key schedule, big-endian words
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

__device__ __forceinline__ uint32_t ror8(uint32_t x) {
  return (x >> 8) | (x << 24);
}

// big-endian keystream word -> the little-endian word that XORs memory
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__global__ void __launch_bounds__(NT)
aes256_ctr_kernel(const RoundKeys rk, uint64_t ctr_hi, uint64_t ctr_lo,
                  uint8_t* __restrict__ data, int64_t n) {
  __shared__ uint32_t T0[256], T1[256], T2[256], T3[256];
  __shared__ uint32_t S[256];
  for (int i = threadIdx.x; i < 256; i += NT) {
    const uint32_t s = SBOX[i];
    const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1b)) & 0xff;
    // column (2s, s, s, 3s): row 0's byte through MixColumns
    const uint32_t t = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
    T0[i] = t;
    T1[i] = ror8(t);
    T2[i] = ror8(ror8(t));
    T3[i] = ror8(ror8(ror8(t)));
    S[i] = s;
  }
  __syncthreads();
  const int64_t nblk = (n + 15) >> 4;
  for (int64_t b = (int64_t)blockIdx.x * NT + threadIdx.x; b < nblk;
       b += (int64_t)gridDim.x * NT) {
    const uint64_t lo = ctr_lo + (uint64_t)b;
    const uint64_t hi = ctr_hi + (lo < ctr_lo ? 1 : 0);
    uint32_t s0 = (uint32_t)(hi >> 32) ^ rk.w[0];
    uint32_t s1 = (uint32_t)hi ^ rk.w[1];
    uint32_t s2 = (uint32_t)(lo >> 32) ^ rk.w[2];
    uint32_t s3 = (uint32_t)lo ^ rk.w[3];
#pragma unroll
    for (int r = 1; r < 14; r++) {
      const uint32_t t0 = T0[s0 >> 24] ^ T1[(s1 >> 16) & 0xff] ^
                          T2[(s2 >> 8) & 0xff] ^ T3[s3 & 0xff] ^ rk.w[4 * r];
      const uint32_t t1 = T0[s1 >> 24] ^ T1[(s2 >> 16) & 0xff] ^
                          T2[(s3 >> 8) & 0xff] ^ T3[s0 & 0xff] ^
                          rk.w[4 * r + 1];
      const uint32_t t2 = T0[s2 >> 24] ^ T1[(s3 >> 16) & 0xff] ^
                          T2[(s0 >> 8) & 0xff] ^ T3[s1 & 0xff] ^
                          rk.w[4 * r + 2];
      const uint32_t t3 = T0[s3 >> 24] ^ T1[(s0 >> 16) & 0xff] ^
                          T2[(s1 >> 8) & 0xff] ^ T3[s2 & 0xff] ^
                          rk.w[4 * r + 3];
      s0 = t0; s1 = t1; s2 = t2; s3 = t3;
    }
    // last round: SubBytes and ShiftRows without MixColumns
    const uint32_t k0 = ((S[s0 >> 24] << 24) | (S[(s1 >> 16) & 0xff] << 16) |
                         (S[(s2 >> 8) & 0xff] << 8) | S[s3 & 0xff]) ^ rk.w[56];
    const uint32_t k1 = ((S[s1 >> 24] << 24) | (S[(s2 >> 16) & 0xff] << 16) |
                         (S[(s3 >> 8) & 0xff] << 8) | S[s0 & 0xff]) ^ rk.w[57];
    const uint32_t k2 = ((S[s2 >> 24] << 24) | (S[(s3 >> 16) & 0xff] << 16) |
                         (S[(s0 >> 8) & 0xff] << 8) | S[s1 & 0xff]) ^ rk.w[58];
    const uint32_t k3 = ((S[s3 >> 24] << 24) | (S[(s0 >> 16) & 0xff] << 16) |
                         (S[(s1 >> 8) & 0xff] << 8) | S[s2 & 0xff]) ^ rk.w[59];
    const int64_t off = b << 4;
    if (off + 16 <= n) {
      uint4* p = reinterpret_cast<uint4*>(data + off);
      uint4 v = *p;
      v.x ^= bswap(k0); v.y ^= bswap(k1); v.z ^= bswap(k2); v.w ^= bswap(k3);
      *p = v;
    } else {
      const uint32_t ks[4] = {k0, k1, k2, k3};
      for (int j = 0; off + j < n; j++)
        data[off + j] ^= (uint8_t)(ks[j >> 2] >> (24 - 8 * (j & 3)));
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
  const int grid = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  aes256_ctr_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      keys, ctr_hi, ctr_lo, (uint8_t*)data, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

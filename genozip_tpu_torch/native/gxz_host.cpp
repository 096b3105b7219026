// The port's C++ host runtime, loaded with ctypes by native/__init__.py.
//
// genozip_tpu_torch's own copy of the host functions of
// genozip_tpu/native/gxz_native.cpp that the port calls, under the same
// names (gxz_*), on the numpy path's bytes: each function returns what the
// port's numpy version of it returns, and that version stays in the port as
// the tests' oracle. It uses the C++ standard library only. Deflate stays in
// Python's zlib, so the order-1 rANS frequency table is framed there
// (gxz_rans_freqs writes it raw); there is no BGZF, zlib or AES code here
// (the AES-CTR route is the CUDA kernel of csrc/aes.cu).
//
// Differences from gxz_native.cpp, each to keep the numpy path's bytes or to
// refuse a damaged archive where the numpy path raises:
//   - decoders bound every read of their input and return < 0 where the
//     numpy version raises (tables that do not sum to 2^12, short streams);
//   - gxz_atoi returns numpy's values on rows that do not parse;
//   - gxz_int_list_stats sums in double, as np.bincount(weights=) does;
//   - gxz_nib_expand reads a short row on into the next bytes, as the numpy
//     gather does;
//   - gxz_ref_populate lets the last read of a batch win a base, skips the
//     bases an earlier VB was diffed against while unset, and recounts the
//     touched blocks; gxz_seq_diff marks those bases (fault F11 not copied);
//   - no function keeps mutable static state: ctypes drops the GIL, and the
//     seg and PIZ threads call in parallel.
//
// The AVX-512 rANS cores are compiled with target attributes and chosen at
// run time (gxz_host_avx512); -DGXZ_NO_AVX512 compiles them out. Both routes
// write the same bytes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC gxz_host.cpp -o libgxz_host.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <vector>
#include <memory>

#if defined(__x86_64__) && !defined(GXZ_NO_AVX512)
#define GXZ_AVX512 1
#include <immintrin.h>
#define GXZ_TARGET_AVX512 __attribute__((target("avx512f,avx512bw,avx512vl")))
#endif

namespace {

constexpr int SCALE_BITS = 12;
constexpr uint32_t SCALE = 1u << SCALE_BITS;
constexpr uint32_t RANS_L = 1u << 16;
constexpr int64_t O1_RAW_CAP = 32 + 256 * (32 + 512);

// rans_np.choose_num_lanes
int choose_log_lanes(int64_t n) {
    if (n <= 0) return 4;
    int64_t target = n / (n >= (1 << 20) ? 128 : 256);
    if (target <= 1) return 4;
    int k = 64 - __builtin_clzll((uint64_t)(target - 1));  // ceil(log2)
    return std::max(4, std::min(13, k));
}

// rans_np.normalize_freqs (largest remainder; ties by (-count, symbol))
void normalize_freqs(const int64_t* hist, uint32_t* f_out) {
    int64_t total = 0;
    for (int i = 0; i < 256; i++) total += hist[i];
    if (total == 0) {
        memset(f_out, 0, 256 * 4);
        f_out[0] = SCALE;
        return;
    }
    int64_t f[256];
    int64_t sum = 0;
    for (int i = 0; i < 256; i++) {
        f[i] = (int64_t)((unsigned __int128)hist[i] * SCALE / (uint64_t)total);
        if (hist[i] > 0 && f[i] == 0) f[i] = 1;
        sum += f[i];
    }
    int64_t diff = SCALE - sum;
    if (diff != 0) {
        int order[256];
        for (int i = 0; i < 256; i++) order[i] = i;
        std::stable_sort(order, order + 256, [&](int a, int b) {
            return hist[a] > hist[b];
        });
        int64_t step = diff > 0 ? 1 : -1;
        int64_t remaining = diff > 0 ? diff : -diff;
        for (int64_t i = 0; remaining > 0; i++) {
            int s = order[i % 256];
            if (hist[s] > 0 && (step > 0 || f[s] > 1)) {
                f[s] += step;
                remaining--;
            }
        }
    }
    for (int i = 0; i < 256; i++) f_out[i] = (uint32_t)f[i];
}

size_t freqs_serialize(const uint32_t* f, uint8_t* out) {
    memset(out, 0, 32);
    size_t off = 32;
    for (int i = 0; i < 256; i++)
        if (f[i] > 0) out[i >> 3] |= (uint8_t)(1u << (i & 7));
    for (int i = 0; i < 256; i++)
        if (f[i] > 0) {
            out[off++] = (uint8_t)(f[i] & 0xFF);
            out[off++] = (uint8_t)(f[i] >> 8);
        }
    return off;
}

// Reads one table from in[0:len); returns bytes used, or -1 when the table
// runs past len or does not sum to SCALE.
int64_t freqs_deserialize(const uint8_t* in, int64_t len, uint32_t* f) {
    if (len < 32) return -1;
    int64_t off = 32;
    uint32_t sum = 0;
    for (int i = 0; i < 256; i++) {
        if (in[i >> 3] & (1u << (i & 7))) {
            if (off + 2 > len) return -1;
            f[i] = (uint32_t)in[off] | ((uint32_t)in[off + 1] << 8);
            sum += f[i];
            off += 2;
        } else {
            f[i] = 0;
        }
    }
    return sum == SCALE ? off : -1;
}

// o0: one table; o1: a bitmap of contexts, then one table per context.
// Fills freq/cum (256 or 65536 entries). Returns false on a bad table.
bool tables_from_raw(const uint8_t* raw, int64_t raw_len, int order,
                     std::vector<uint32_t>& freq, std::vector<uint32_t>& cum) {
    if (order == 0) {
        freq.assign(256, 0); cum.assign(256, 0);
        if (freqs_deserialize(raw, raw_len, freq.data()) < 0) return false;
        uint32_t c = 0;
        for (int s = 0; s < 256; s++) { cum[s] = c; c += freq[s]; }
        return true;
    }
    freq.assign(65536, 0); cum.assign(65536, 0);
    if (raw_len < 32) return false;
    int64_t o = 32;
    for (int c0 = 0; c0 < 256; c0++) {
        if (!(raw[c0 >> 3] & (1u << (c0 & 7)))) continue;
        int64_t used = freqs_deserialize(raw + o, raw_len - o,
                                         &freq[(size_t)c0 * 256]);
        if (used < 0) return false;
        o += used;
        uint32_t cc = 0;
        for (int s = 0; s < 256; s++) {
            cum[(size_t)c0 * 256 + s] = cc;
            cc += freq[(size_t)c0 * 256 + s];
        }
    }
    return true;
}

// Granlund-Montgomery magic division: q = (x * M) >> (32 + l), exact for
// all x < 2^32 when e = M*d - 2^(32+l) satisfies 0 < e <= 2^l.
struct Magic {
    uint64_t M;
    int sh;
    bool exact;
};

Magic make_magic(uint32_t d) {
    if (d == 0) return {0, 0, false};
    int l = 0;
    while ((1u << l) < d) l++;
    if ((d & (d - 1)) == 0)
        return {(uint64_t)1 << 32, 32 + l, true};
    uint64_t two_pow = (uint64_t)1 << (32 + l);
    uint64_t M = (two_pow + d - 1) / d;
    uint64_t e = M * d - two_pow;
    return {M, 32 + l, e > 0 && e <= ((uint64_t)1 << l)};
}

inline uint32_t magic_div(uint32_t x, const Magic& m, uint32_t d) {
    if (__builtin_expect(!m.exact, 0)) return x / d;
    return (uint32_t)(((unsigned __int128)x * m.M) >> m.sh);
}

// (K, N) step-row plane -> (N, K) lane-chunk output, cache-blocked
void rans_transpose_out(const uint8_t* plane, int64_t n, int64_t K, int N,
                        uint8_t* out) {
    constexpr int64_t B = 64;
    for (int64_t t0 = 0; t0 < K; t0 += B)
        for (int64_t l0 = 0; l0 < N; l0 += B) {
            int64_t t1 = std::min(t0 + B, K), l1 = std::min(l0 + B, (int64_t)N);
            for (int64_t l = l0; l < l1; l++) {
                int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
                int64_t tmax = std::min(t1, lane_end - l * K);
                for (int64_t t = t0; t < tmax; t++)
                    out[l * K + t] = plane[(size_t)t * N + l];
            }
        }
}

#ifdef GXZ_AVX512
// (N, K) lane-chunk layout -> (K, N) step-row plane, cache-blocked
void rans_transpose_in(const uint8_t* data, int64_t n, int64_t K, int N,
                       uint8_t* plane) {
    constexpr int64_t B = 64;
    for (int64_t l0 = 0; l0 < N; l0 += B)
        for (int64_t t0 = 0; t0 < K; t0 += B) {
            int64_t l1 = std::min(l0 + B, (int64_t)N), t1 = std::min(t0 + B, K);
            for (int64_t l = l0; l < l1; l++) {
                int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
                int64_t tmax = std::min(t1, lane_end - l * K);
                for (int64_t t = t0; t < tmax; t++)
                    plane[(size_t)t * N + l] = data[l * K + t];
            }
        }
}

// ---------------------------------------------------------------------------
// AVX-512 rANS cores.  16 lanes of u32 states fill one zmm, so both passes
// run one zmm per lane group:
//   encode: the division by freq is a Granlund-Montgomery round-up multiply;
//           renorm words are written backward with vpcompressd + a 16-bit
//           truncate (the scalar coder's lane layout, renorm rule
//           (x >> 20 >= f) and (t asc, lane asc) word order);
//   decode: one fused u32 gather per step [sym(8) | freq-1(12) | cum(12)],
//           renorm words injected with vpexpandd.
// The input is transposed once into a (K, N) plane so each step reads 16
// contiguous bytes; the order-1 context row is the previous plane row.
// ---------------------------------------------------------------------------

GXZ_TARGET_AVX512
inline __m512i mulhi_epu32(__m512i a, __m512i b) {
    __m512i lo = _mm512_mul_epu32(a, b);
    __m512i hi = _mm512_mul_epu32(_mm512_srli_epi64(a, 32),
                                  _mm512_srli_epi64(b, 32));
    lo = _mm512_srli_epi64(lo, 32);
    return _mm512_mask_blend_epi32(0xAAAA, lo, hi);
}

// per-symbol encode tables: M = ceil(2^(32+l)/f), l = ceil(log2 f), exact
// for all x < 2^32; with m = M - 2^32: hi = mulhi(x, m),
// q = (hi + ((x - hi) >> 1)) >> (l - 1).  freq 1: m = ~0 gives q = x - 1,
// and bias = cum + SCALE - 1 absorbs the off-by-one.
//   t0 = freq(13) | bias(13) << 13 | sh(4) << 26,  t1 = m.
void build_enc_tables(const uint32_t* freq, const uint32_t* cum, size_t ntab,
                      uint32_t* t0, uint32_t* t1) {
    for (size_t i = 0; i < ntab; i++) {
        uint32_t f = freq[i];
        if (!f) { t0[i] = 0; t1[i] = 0; continue; }
        uint32_t m, sh, bias;
        if (f < 2) {
            m = ~0u; sh = 0; bias = cum[i] + SCALE - 1;
        } else {
            uint32_t l = 0;
            while (f > (1u << l)) l++;
            uint64_t M = ((((uint64_t)1 << (32 + l)) + f - 1) / f);
            m = (uint32_t)(M - ((uint64_t)1 << 32));
            sh = l - 1; bias = cum[i];
        }
        t0[i] = f | (bias << 13) | (sh << 26);
        t1[i] = m;
    }
}

// fills words[] backward from words + cap; returns the start index and the
// final states in x[]
GXZ_TARGET_AVX512
int64_t rans_encode_core_avx512(const uint8_t* plane, int64_t n, int64_t K,
                                int N, int order, const uint32_t* t0,
                                const uint32_t* t1, uint32_t* x,
                                uint16_t* words, int64_t cap) {
    int64_t p = cap;
    int64_t L_full = K ? n / K : 0, rem = K ? n - L_full * K : 0;
    const __m512i m13 = _mm512_set1_epi32(0x1FFF);
    const __m512i mscale = _mm512_set1_epi32((int)SCALE);
    for (int64_t t = K - 1; t >= 0; t--) {
        int64_t active = L_full + (t < rem ? 1 : 0);
        const uint8_t* row = plane + (size_t)t * N;
        const uint8_t* prow = (order && t) ? row - N : nullptr;
        for (int g = N - 16; g >= 0; g -= 16) {
            if (g >= active) continue;
            __mmask16 am = (active - g >= 16)
                ? (__mmask16)0xFFFF : (__mmask16)((1u << (active - g)) - 1);
            __m512i ix = _mm512_cvtepu8_epi32(
                _mm_loadu_si128((const __m128i*)(row + g)));
            if (order) {
                __m512i ctx = prow
                    ? _mm512_cvtepu8_epi32(
                          _mm_loadu_si128((const __m128i*)(prow + g)))
                    : _mm512_setzero_si512();
                ix = _mm512_add_epi32(_mm512_slli_epi32(ctx, 8), ix);
            }
            __m512i e0 = _mm512_mask_i32gather_epi32(
                _mm512_setzero_si512(), am, ix, t0, 4);
            __m512i f = _mm512_and_si512(e0, m13);
            __m512i bias = _mm512_and_si512(_mm512_srli_epi32(e0, 13), m13);
            __m512i sh = _mm512_srli_epi32(e0, 26);
            __m512i xv = _mm512_loadu_si512(x + g);
            __mmask16 rm = _mm512_mask_cmpge_epu32_mask(
                am, _mm512_srli_epi32(xv, 20), f);
            int cnt = __builtin_popcount((unsigned)rm);
            if (cnt) {
                __m512i packed = _mm512_maskz_compress_epi32(rm, xv);
                __m256i w16 = _mm512_cvtepi32_epi16(packed);
                p -= cnt;
                _mm256_mask_storeu_epi16(words + p,
                                         (__mmask16)((1u << cnt) - 1), w16);
                xv = _mm512_mask_srli_epi32(xv, rm, xv, 16);
            }
            __m512i m = _mm512_mask_i32gather_epi32(
                _mm512_setzero_si512(), am, ix, t1, 4);
            __m512i hi = mulhi_epu32(xv, m);
            __m512i tq = _mm512_add_epi32(
                hi, _mm512_srli_epi32(_mm512_sub_epi32(xv, hi), 1));
            __m512i q = _mm512_srlv_epi32(tq, sh);
            __m512i cmpl = _mm512_sub_epi32(mscale, f);
            __m512i xn = _mm512_add_epi32(
                _mm512_add_epi32(xv, bias), _mm512_mullo_epi32(q, cmpl));
            xv = _mm512_mask_blend_epi32(am, xv, xn);
            _mm512_storeu_si512(x + g, xv);
        }
    }
    return p;
}

// consumes words[] forward from index p, writes the (K, N) plane; tab is
// the fused per-slot table (o0: SCALE entries, o1: 256 * SCALE). Returns
// the final p, or -1 when the words run out.
GXZ_TARGET_AVX512
int64_t rans_decode_core_avx512(uint8_t* plane, int64_t n, int64_t K, int N,
                                int order, const uint32_t* tab, uint32_t* x,
                                const uint16_t* words, int64_t nwords,
                                int64_t p) {
    int64_t L_full = K ? n / K : 0, rem = K ? n - L_full * K : 0;
    const __m512i mslot = _mm512_set1_epi32((int)(SCALE - 1));
    const __m512i m12 = _mm512_set1_epi32(0xFFF);
    const __m512i m8 = _mm512_set1_epi32(0xFF);
    const __m512i one = _mm512_set1_epi32(1);
    const __m512i lbound = _mm512_set1_epi32((int)RANS_L);
    for (int64_t t = 0; t < K; t++) {
        int64_t active = L_full + (t < rem ? 1 : 0);
        uint8_t* row = plane + (size_t)t * N;
        const uint8_t* prow = (order && t) ? row - N : nullptr;
        for (int g = 0; g < N; g += 16) {
            if (g >= active) break;
            __mmask16 am = (active - g >= 16)
                ? (__mmask16)0xFFFF : (__mmask16)((1u << (active - g)) - 1);
            __m512i xv = _mm512_loadu_si512(x + g);
            __m512i slot = _mm512_and_si512(xv, mslot);
            __m512i ix = slot;
            if (order) {
                __m512i ctx = prow
                    ? _mm512_cvtepu8_epi32(
                          _mm_loadu_si128((const __m128i*)(prow + g)))
                    : _mm512_setzero_si512();
                ix = _mm512_add_epi32(_mm512_slli_epi32(ctx, SCALE_BITS), slot);
            }
            __m512i e = _mm512_mask_i32gather_epi32(
                _mm512_setzero_si512(), am, ix, tab, 4);
            __m512i sym = _mm512_and_si512(e, m8);
            __m512i f = _mm512_add_epi32(
                _mm512_and_si512(_mm512_srli_epi32(e, 8), m12), one);
            __m512i c = _mm512_srli_epi32(e, 20);
            __m512i xn = _mm512_add_epi32(
                _mm512_mullo_epi32(f, _mm512_srli_epi32(xv, SCALE_BITS)),
                _mm512_sub_epi32(slot, c));
            xv = _mm512_mask_blend_epi32(am, xv, xn);
            __mmask16 rm = _mm512_mask_cmplt_epu32_mask(am, xv, lbound);
            int cnt = __builtin_popcount((unsigned)rm);
            if (cnt) {
                __m512i wv = _mm512_cvtepu16_epi32(
                    _mm256_loadu_si256((const __m256i*)(words + p)));
                wv = _mm512_maskz_expand_epi32(rm, wv);
                __m512i xr = _mm512_or_si512(_mm512_slli_epi32(xv, 16), wv);
                xv = _mm512_mask_blend_epi32(rm, xv, xr);
                p += cnt;
            }
            _mm512_storeu_si512(x + g, xv);
            _mm_storeu_si128((__m128i*)(row + g), _mm512_cvtepi32_epi8(sym));
        }
        if (p > nwords) return -1;
    }
    return p;
}
#endif  // GXZ_AVX512

// ---------------------------------------------------------------------------
// ARITH-W32: N lockstep carryless range-coder lanes sharing one adaptive
// model (ops/arith_np.py). The model keeps freq[] and a lazily rebuilt
// exclusive prefix per context.
// ---------------------------------------------------------------------------
namespace arith {

constexpr uint32_t A_TOP = 1u << 24, A_BOT = 1u << 16;
constexpr uint32_t A_INC = 24, A_MAX_TOTAL = 1u << 15;

int a_choose_log_lanes(int64_t n) {
    if (n < (1 << 12)) return 4;
    if (n < (1 << 18)) return 6;
    return 8;
}

struct Model {
    int nctx;
    std::vector<uint32_t> freq;    // nctx*256
    std::vector<uint32_t> total;   // nctx
    std::vector<uint32_t> pre;     // nctx*257 exclusive prefix (lazy)
    std::vector<uint8_t> dirty;    // bit 0: pre stale; bit 1: start stale
    std::vector<uint8_t> start;    // nctx*256 bucket -> first symbol (lazy)
    std::vector<uint8_t> bsh;      // nctx: bucket shift

    explicit Model(int order) : nctx(order ? 256 : 1),
        freq((size_t)nctx * 256, 1), total(nctx, 256),
        pre((size_t)nctx * 257, 0), dirty(nctx, 3),
        start((size_t)nctx * 256, 0), bsh(nctx, 0) {}
    inline const uint32_t* snap(int c) {
        uint32_t* p = &pre[(size_t)c * 257];
        if (dirty[c] & 1) {
            const uint32_t* f = &freq[(size_t)c * 256];
            uint32_t acc = 0;
            for (int i = 0; i < 256; i++) { p[i] = acc; acc += f[i]; }
            p[256] = acc;
            dirty[c] &= ~1;
        }
        return p;
    }
    inline void add(int c, int s, uint32_t d) {
        freq[(size_t)c * 256 + s] += d;
        total[c] += d;
        dirty[c] = 3;
    }
    // largest sym with prefix(sym) <= v; sets cum = prefix(sym)
    inline int search_ctx(int c, const uint32_t* p, uint32_t v,
                          uint32_t* cum) {
        uint8_t* st = &start[(size_t)c * 256];
        if (dirty[c] & 2) {
            uint32_t tot = p[256];
            int sh = 0;
            while ((uint64_t)(tot - 1) >> sh >= 256) sh++;
            bsh[c] = (uint8_t)sh;
            int s = 0;
            for (int b = 0; b < 256; b++) {
                uint32_t v0 = (uint32_t)b << sh;
                while (s < 255 && p[s + 1] <= v0) s++;
                st[b] = (uint8_t)s;
            }
            dirty[c] &= ~2;
        }
        int s = st[v >> bsh[c]];
        while (s < 255 && p[s + 1] <= v) s++;
        *cum = p[s];
        return s;
    }
    void rescale(int c) {
        while (total[c] > A_MAX_TOTAL) {
            uint32_t* f = &freq[(size_t)c * 256];
            uint32_t tot = 0;
            for (int i = 0; i < 256; i++) { f[i] = (f[i] + 1) >> 1; tot += f[i]; }
            total[c] = tot;
        }
        dirty[c] = 3;
    }
};

}  // namespace arith

// XXH64 (public spec)
constexpr uint64_t XP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t XP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t XP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t XP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t XP5 = 0x27D4EB2F165667C5ULL;
inline uint64_t xrotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xread64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}
inline uint32_t xread32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}
inline uint64_t xround(uint64_t acc, uint64_t input) {
    acc += input * XP2; acc = xrotl(acc, 31); return acc * XP1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t val) {
    acc ^= xround(0, val); return acc * XP1 + XP4;
}

// "int(,int)*" with 1..18 digits an item and no leading zero on a
// multi-digit item (the tokenizer's keep rules plus the canonical check of
// the port's _comma_ints). Calls item(v) for each value; false when the row
// does not parse.
template <class F>
inline bool parse_int_list(const uint8_t* data, int64_t p, int64_t end,
                           F item) {
    if (p >= end) return false;
    while (p < end) {
        int64_t st = p;
        int64_t v = 0;
        while (p < end && data[p] >= '0' && data[p] <= '9') {
            v = v * 10 + (data[p] - '0');
            p++;
        }
        int64_t dl = p - st;
        if (dl < 1 || dl > 18 || (dl > 1 && data[st] == '0')) return false;
        item(v);
        if (p < end) {
            if (data[p] != ',') return false;
            p++;
            if (p == end) return false;   // trailing comma
        }
    }
    return true;
}

}  // namespace

extern "C" {

// 1 when the AVX-512 rANS cores were compiled in and the CPU runs them.
int gxz_host_avx512() {
#ifdef GXZ_AVX512
    __builtin_cpu_init();
    return __builtin_cpu_supports("avx512f") &&
           __builtin_cpu_supports("avx512bw") &&
           __builtin_cpu_supports("avx512vl");
#else
    return 0;
#endif
}

// 1 when the AVX-512 cores were compiled in (whatever the CPU).
int gxz_host_avx512_compiled() {
#ifdef GXZ_AVX512
    return 1;
#else
    return 0;
#endif
}

int gxz_rans_log_lanes(int64_t n) { return choose_log_lanes(n); }

// ---------------------------------------------------------------------------
// rANS (ops/rans_np.py, the RANS-W32x16 stream).  gxz_rans_freqs writes the
// frequency table raw: o0 the serialized table (it goes in the header as
// is), o1 the context bitmap and one table per context (Python deflates it).
// Returns the raw length.
// ---------------------------------------------------------------------------
int64_t gxz_rans_freqs(const uint8_t* data, int64_t n, int order,
                       uint8_t* raw) {
    if (order == 0) {
        int64_t h4[4][256] = {{0}};
        int64_t i = 0;
        for (; i + 4 <= n; i += 4) {
            h4[0][data[i]]++; h4[1][data[i + 1]]++;
            h4[2][data[i + 2]]++; h4[3][data[i + 3]]++;
        }
        for (; i < n; i++) h4[0][data[i]]++;
        int64_t hist[256];
        for (int s = 0; s < 256; s++)
            hist[s] = h4[0][s] + h4[1][s] + h4[2][s] + h4[3][s];
        uint32_t f[256];
        normalize_freqs(hist, f);
        return (int64_t)freqs_serialize(f, raw);
    }
    int N = 1 << choose_log_lanes(n);
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    std::vector<int64_t> hist2(256 * 256, 0);
    for (int l = 0; l < N; l++) {
        int64_t s0 = (int64_t)l * K, s1 = std::min(s0 + K, n);
        uint8_t ctx = 0;
        for (int64_t i = s0; i < s1; i++) {
            hist2[(size_t)ctx * 256 + data[i]]++;
            ctx = data[i];
        }
    }
    memset(raw, 0, 32);
    int64_t off = 32;
    uint32_t f[256];
    for (int c0 = 0; c0 < 256; c0++) {
        int64_t t = 0;
        for (int s = 0; s < 256; s++) t += hist2[(size_t)c0 * 256 + s];
        if (t == 0) continue;
        raw[c0 >> 3] |= (uint8_t)(1u << (c0 & 7));
        normalize_freqs(&hist2[(size_t)c0 * 256], f);
        off += (int64_t)freqs_serialize(f, raw + off);
    }
    return off;
}

// Body of the stream (2N state words, then the renorm words) for the table
// that gxz_rans_freqs wrote. out needs 2 * (n + 2N + 8) bytes. Returns the
// body's bytes, or < 0.
int64_t gxz_rans_encode(const uint8_t* data, int64_t n, int order,
                        const uint8_t* raw, int64_t raw_len,
                        uint8_t* out, int64_t out_cap) {
    int N = 1 << choose_log_lanes(n);
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    std::vector<uint32_t> freq, cum;
    if (!tables_from_raw(raw, raw_len, order, freq, cum)) return -1;
    int64_t max_words = n + 2 * (int64_t)N + 8;
    if (out_cap < max_words * 2) return -2;

#ifdef GXZ_AVX512
    if (n >= 1024 && gxz_host_avx512()) {
        size_t ntab = order == 0 ? 256 : (size_t)256 * 256;
        std::vector<uint32_t> t0(ntab), t1(ntab);
        build_enc_tables(freq.data(), cum.data(), ntab, t0.data(), t1.data());
        // cells past n are read only through masked gathers
        std::unique_ptr<uint8_t[]> plane(new uint8_t[(size_t)K * N]);
        rans_transpose_in(data, n, K, N, plane.get());
        std::vector<uint32_t> xs(N, RANS_L);
        std::unique_ptr<uint16_t[]> vwords(new uint16_t[max_words]);
        int64_t p = rans_encode_core_avx512(plane.get(), n, K, N, order,
                                            t0.data(), t1.data(), xs.data(),
                                            vwords.get(), max_words);
        for (int l = N - 1; l >= 0; l--) {
            vwords[--p] = (uint16_t)(xs[l] & 0xFFFF);
            vwords[--p] = (uint16_t)(xs[l] >> 16);
        }
        int64_t nw = max_words - p;
        memcpy(out, &vwords[p], (size_t)nw * 2);
        return nw * 2;
    }
#endif

    size_t ntab = order == 0 ? 256 : 256 * 256;
    std::vector<Magic> magic(ntab);
    for (size_t i = 0; i < ntab; i++)
        if (freq[i]) magic[i] = make_magic(freq[i]);

    // pass A: per-lane encode (a lane's chunk is contiguous input) into
    // per-lane word buffers plus emit bitsets
    std::vector<uint32_t> x(N, RANS_L);
    std::unique_ptr<uint16_t[]> lane_words(new uint16_t[n + N]);
    int64_t bits_per_lane = (K + 63) / 64 + 1;
    std::vector<uint64_t> flags((size_t)bits_per_lane * N, 0);
    std::vector<int64_t> lane_wstart(N + 1, 0);
    for (int l = 0; l < N; l++) {
        int64_t lane_len = std::min((int64_t)(l + 1) * K, n) - (int64_t)l * K;
        if (lane_len < 0) lane_len = 0;
        lane_wstart[l + 1] = lane_wstart[l] + lane_len;
    }
    // four lanes interleaved break the per-lane dependency chain
    for (int g = 0; g < N; g += 4) {
        int nl = std::min(4, N - g);
        int64_t s0[4], len[4], wc[4] = {0, 0, 0, 0};
        uint32_t xx[4];
        uint16_t* wbuf[4];
        uint64_t* fl[4];
        int64_t tmax = 0;
        for (int j = 0; j < nl; j++) {
            int l = g + j;
            s0[j] = (int64_t)l * K;
            len[j] = std::max((int64_t)0, std::min(s0[j] + K, n) - s0[j]);
            xx[j] = RANS_L;
            wbuf[j] = &lane_words[lane_wstart[l]];
            fl[j] = &flags[(size_t)bits_per_lane * l];
            tmax = std::max(tmax, len[j]);
        }
        for (int64_t t = tmax - 1; t >= 0; t--) {
            for (int j = 0; j < nl; j++) {
                if (t >= len[j]) continue;
                uint8_t s = data[s0[j] + t];
                size_t ix;
                if (order == 0) ix = s;
                else {
                    uint8_t ctx = (t == 0) ? 0 : data[s0[j] + t - 1];
                    ix = (size_t)ctx * 256 + s;
                }
                uint32_t f = freq[ix], c = cum[ix];
                uint32_t v = xx[j];
                if ((v >> 20) >= f) {
                    wbuf[j][wc[j]++] = (uint16_t)(v & 0xFFFF);
                    v >>= 16;
                    fl[j][t >> 6] |= (uint64_t)1 << (t & 63);
                }
                uint32_t q = magic_div(v, magic[ix], f);
                xx[j] = (q << SCALE_BITS) + (v - q * f) + c;
            }
        }
        for (int j = 0; j < nl; j++) x[g + j] = xx[j];
    }

    // pass B: merge in (step desc, lane desc) order, writing backward
    std::unique_ptr<uint16_t[]> words(new uint16_t[max_words]);
    int64_t p = max_words;
    std::vector<int64_t> consumed(N, 0);
    for (int64_t t = K - 1; t >= 0; t--) {
        int64_t word_idx = t >> 6;
        uint64_t bit = (uint64_t)1 << (t & 63);
        for (int l = N - 1; l >= 0; l--) {
            if (flags[(size_t)bits_per_lane * l + word_idx] & bit)
                words[--p] = lane_words[lane_wstart[l] + consumed[l]++];
        }
    }
    for (int l = N - 1; l >= 0; l--) {
        words[--p] = (uint16_t)(x[l] & 0xFFFF);
        words[--p] = (uint16_t)(x[l] >> 16);
    }
    int64_t nwords = max_words - p;
    memcpy(out, &words[p], (size_t)nwords * 2);
    return nwords * 2;
}

// Decode a whole stream in[0:in_len). o0 reads its table from the stream;
// o1 takes the inflated table (raw1) and the offset of the words. Returns n,
// or < 0 for a damaged stream.
int64_t gxz_rans_decode(const uint8_t* in, int64_t in_len,
                        const uint8_t* raw1, int64_t raw1_len,
                        int64_t words_off,
                        uint8_t* out, int64_t out_cap) {
    if (in_len < 6) return -1;
    int logN = in[0], order = in[1];
    if (logN > 16 || order > 1) return -1;
    int N = 1 << logN;
    uint32_t n32;
    memcpy(&n32, in + 2, 4);
    int64_t n = n32;
    if (out_cap < n) return -1;
    std::vector<uint32_t> freq, cum;
    int64_t off;
    if (order == 0) {
        freq.assign(256, 0);
        int64_t used = freqs_deserialize(in + 6, in_len - 6, freq.data());
        if (used < 0) return -3;
        off = 6 + used;
        cum.assign(256, 0);
        uint32_t c = 0;
        for (int s = 0; s < 256; s++) { cum[s] = c; c += freq[s]; }
    } else {
        if (!tables_from_raw(raw1, raw1_len, 1, freq, cum)) return -3;
        off = words_off;
        if (off > in_len) return -1;
    }
    int64_t nwords = (in_len - off) / 2;
    if (nwords < 2 * (int64_t)N) return -2;
    int64_t K = n > 0 ? (n + N - 1) / N : 0;

#ifdef GXZ_AVX512
    if (n >= 1024 && N >= 16 && gxz_host_avx512()) {
        // fused per-slot table: sym(8) | freq-1(12) | cum(12)
        size_t nctx = order ? 256 : 1;
        std::vector<uint32_t> tab(nctx * SCALE, 0);
        for (size_t c0 = 0; c0 < nctx; c0++) {
            uint32_t* trow = &tab[c0 * SCALE];
            const uint32_t* f = &freq[c0 * 256];
            const uint32_t* cm = &cum[c0 * 256];
            for (int s = 0; s < 256; s++)
                for (uint32_t j = 0; j < f[s]; j++)
                    trow[cm[s] + j] =
                        (uint32_t)s | ((f[s] - 1) << 8) | (cm[s] << 20);
        }
        // the cursor is checked once per plane row, during which a damaged
        // stream can move it by up to N; each renorm loads 32 bytes at the
        // cursor, so pad by N + 16 words
        std::vector<uint16_t> wpad((size_t)nwords + (size_t)N + 16, 0);
        memcpy(wpad.data(), in + off, (size_t)nwords * 2);
        std::vector<uint32_t> x(N);
        for (int l = 0; l < N; l++)
            x[l] = ((uint32_t)wpad[2 * l] << 16) | wpad[2 * l + 1];
        std::vector<uint8_t> plane((size_t)K * N, 0);
        int64_t p = rans_decode_core_avx512(plane.data(), n, K, N, order,
                                            tab.data(), x.data(), wpad.data(),
                                            nwords, 2 * N);
        if (p < 0) return -2;
        rans_transpose_out(plane.data(), n, K, N, out);
        return n;
    }
#endif

    std::vector<uint8_t> slot2sym(order ? (size_t)256 * SCALE : SCALE, 0);
    for (size_t c0 = 0; c0 < (order ? 256u : 1u); c0++) {
        const uint32_t* f = &freq[c0 * 256];
        const uint32_t* cm = &cum[c0 * 256];
        for (int s = 0; s < 256; s++)
            for (uint32_t j = 0; j < f[s]; j++)
                slot2sym[c0 * SCALE + cm[s] + j] = (uint8_t)s;
    }
    std::vector<uint16_t> words((size_t)nwords);
    memcpy(words.data(), in + off, (size_t)nwords * 2);
    std::vector<uint32_t> x(N);
    for (int l = 0; l < N; l++)
        x[l] = ((uint32_t)words[2 * l] << 16) | words[2 * l + 1];
    int64_t p = 2 * N;
    std::vector<uint8_t> plane((size_t)K * N);
    std::vector<uint8_t> ctxv(N, 0);
    for (int64_t t = 0; t < K; t++) {
        uint8_t* row = &plane[(size_t)t * N];
        for (int l = 0; l < N; l++) {
            int64_t i = (int64_t)l * K + t;
            int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
            if (i >= lane_end) { row[l] = 0; continue; }
            uint32_t xx = x[l];
            uint32_t slot = xx & (SCALE - 1);
            uint8_t s;
            uint32_t f, c;
            if (order == 0) {
                s = slot2sym[slot];
                f = freq[s]; c = cum[s];
            } else {
                uint8_t cc0 = ctxv[l];
                s = slot2sym[(size_t)cc0 * SCALE + slot];
                f = freq[(size_t)cc0 * 256 + s];
                c = cum[(size_t)cc0 * 256 + s];
                ctxv[l] = s;
            }
            xx = f * (xx >> SCALE_BITS) + slot - c;
            if (xx < RANS_L) {
                if (p >= nwords) return -2;
                xx = (xx << 16) | words[p++];
            }
            x[l] = xx;
            row[l] = s;
        }
    }
    rans_transpose_out(plane.data(), n, K, N, out);
    return n;
}

// ---------------------------------------------------------------------------
// ARITH-W32 encode/decode (ops/arith_np.py)
// ---------------------------------------------------------------------------
int64_t gxz_arith_encode(const uint8_t* data, int64_t n, int order,
                         uint8_t* out, int64_t cap) {
    using namespace arith;
    int logN = a_choose_log_lanes(n);
    int N = 1 << logN;
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    std::vector<int64_t> lane_len(N);
    for (int l = 0; l < N; l++) {
        int64_t v = n - (int64_t)l * K;
        lane_len[l] = v < 0 ? 0 : (v > K ? K : v);
    }
    std::vector<uint32_t> low(N, 0), rng(N, 0xFFFFFFFFu);
    std::vector<std::vector<uint8_t>> lane_bytes(N);
    std::vector<uint8_t> ev;              // global event order: lane ids
    Model model(order);
    std::vector<uint8_t> syms(N), ctxs(N);
    std::vector<int> dirty;
    // lanes in one context at one step divide by the same total
    std::vector<Magic> mag(model.nctx);
    std::vector<int64_t> mag_gen(model.nctx, -1);
    std::vector<int> active(N), pend(N);
    ev.reserve((size_t)n / 2 + 64);

    for (int64_t t = 0; t < K; t++) {
        int na = 0;
        for (int l = 0; l < N; l++)
            if (t < lane_len[l]) active[na++] = l;
        for (int ai = 0; ai < na; ai++) {
            int l = active[ai];
            uint8_t s = data[(int64_t)l * K + t];
            uint8_t cx = (order && t) ? data[(int64_t)l * K + t - 1] : 0;
            syms[l] = s; ctxs[l] = cx;
            uint32_t tot = model.total[cx];
            if (mag_gen[cx] != t) { mag[cx] = make_magic(tot); mag_gen[cx] = t; }
            uint32_t f = model.freq[(size_t)cx * 256 + s];
            uint32_t c = model.snap(cx)[s];
            uint32_t r = magic_div(rng[l], mag[cx], tot);
            low[l] += c * r;
            rng[l] = f * r;
        }
        // renorm iteration-major (the numpy spec's byte interleave)
        int np_ = na;
        int* cur = active.data();
        int* nxt = pend.data();
        while (np_) {
            int nn = 0;
            for (int i = 0; i < np_; i++) {
                int l = cur[i];
                uint32_t lo = low[l], rg = rng[l];
                bool c1 = ((lo ^ (lo + rg)) < A_TOP), c2 = rg < A_BOT;
                if (!(c1 || c2)) continue;
                if (!c1) rng[l] = (0u - lo) & (A_BOT - 1);
                lane_bytes[l].push_back((uint8_t)(lo >> 24));
                ev.push_back((uint8_t)l);
                low[l] <<= 8; rng[l] <<= 8;
                nxt[nn++] = l;
            }
            np_ = nn;
            std::swap(cur, nxt);
        }
        dirty.clear();
        for (int l = 0; l < N; l++) {
            if (t >= lane_len[l]) continue;
            int cx = order ? ctxs[l] : 0;
            model.add(cx, syms[l], A_INC);
            if (model.total[cx] > A_MAX_TOTAL) dirty.push_back(cx);
        }
        for (int cx : dirty)
            if (model.total[cx] > A_MAX_TOTAL) model.rescale(cx);
    }
    for (int l = 0; l < N; l++)
        for (int k = 0; k < 4; k++) {
            lane_bytes[l].push_back((uint8_t)(low[l] >> 24));
            low[l] <<= 8;
        }

    int64_t need = 6 + 4LL * N + (int64_t)ev.size();
    if (need > cap) return -1;
    uint8_t* p = out;
    *p++ = (uint8_t)logN; *p++ = (uint8_t)order;
    for (int k = 0; k < 4; k++) *p++ = (uint8_t)((uint64_t)n >> (8 * k));
    for (int l = 0; l < N; l++)
        for (int k = 0; k < 4; k++) *p++ = lane_bytes[l][k];
    std::vector<int64_t> j(N, 0);
    for (int32_t l : ev) *p++ = lane_bytes[l][4 + j[l]++];
    return p - out;
}

int64_t gxz_arith_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                         int64_t n_expect) {
    using namespace arith;
    if (in_len < 6) return -1;
    int logN = in[0], order = in[1];
    if (logN > 16 || order > 1) return -1;
    int N = 1 << logN;
    int64_t n = 0;
    for (int k = 0; k < 4; k++) n |= (int64_t)in[2 + k] << (8 * k);
    if (n != n_expect) return -2;
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    std::vector<int64_t> lane_len(N);
    for (int l = 0; l < N; l++) {
        int64_t v = n - (int64_t)l * K;
        lane_len[l] = v < 0 ? 0 : (v > K ? K : v);
    }
    const uint8_t* body = in + 6;
    const uint8_t* bend = in + in_len;
    if (bend - body < 4LL * N) return -3;
    std::vector<uint32_t> low(N, 0), rng(N, 0xFFFFFFFFu), code(N);
    for (int l = 0; l < N; l++) {
        code[l] = ((uint32_t)body[0] << 24) | ((uint32_t)body[1] << 16) |
                  ((uint32_t)body[2] << 8) | body[3];
        body += 4;
    }
    Model model(order);
    std::vector<uint8_t> syms(N), ctxs(N);
    std::vector<int> dirty;
    std::vector<Magic> mag(model.nctx);
    std::vector<int64_t> mag_gen(model.nctx, -1);
    std::vector<int> active(N), pend(N);
    for (int64_t t = 0; t < K; t++) {
        int na = 0;
        for (int l = 0; l < N; l++)
            if (t < lane_len[l]) active[na++] = l;
        for (int ai = 0; ai < na; ai++) {
            int l = active[ai];
            uint8_t cx = (order && t) ? out[(int64_t)l * K + t - 1] : 0;
            ctxs[l] = cx;
            uint32_t tot = model.total[cx];
            if (mag_gen[cx] != t) { mag[cx] = make_magic(tot); mag_gen[cx] = t; }
            uint32_t r = magic_div(rng[l], mag[cx], tot);
            uint32_t v = (code[l] - low[l]) / (r ? r : 1);
            if (v > tot - 1) v = tot - 1;
            uint32_t c;
            int s = model.search_ctx(cx, model.snap(cx), v, &c);
            uint32_t f = model.freq[(size_t)cx * 256 + s];
            low[l] += c * r;
            rng[l] = f * r;
            out[(int64_t)l * K + t] = (uint8_t)s;
            syms[l] = (uint8_t)s;
        }
        int np_ = na;
        int* cur = active.data();
        int* nxt = pend.data();
        while (np_) {
            int nn = 0;
            for (int i = 0; i < np_; i++) {
                int l = cur[i];
                uint32_t lo = low[l], rg = rng[l];
                bool c1 = ((lo ^ (lo + rg)) < A_TOP), c2 = rg < A_BOT;
                if (!(c1 || c2)) continue;
                if (!c1) rng[l] = (0u - lo) & (A_BOT - 1);
                if (body >= bend) return -4;
                code[l] = (code[l] << 8) | *body++;
                low[l] <<= 8; rng[l] <<= 8;
                nxt[nn++] = l;
            }
            np_ = nn;
            std::swap(cur, nxt);
        }
        dirty.clear();
        for (int l = 0; l < N; l++) {
            if (t >= lane_len[l]) continue;
            int cx = order ? ctxs[l] : 0;
            model.add(cx, syms[l], A_INC);
            if (model.total[cx] > A_MAX_TOTAL) dirty.push_back(cx);
        }
        for (int cx : dirty)
            if (model.total[cx] > A_MAX_TOTAL) model.rescale(cx);
    }
    return n;
}

// ---------------------------------------------------------------------------
// Codec helpers (codecs/__init__.py, codecs/bwt.py, ops/pbwt.py)
// ---------------------------------------------------------------------------

// 256-bin byte histogram (four tables break the store-forward chain)
void gxz_byte_hist(const uint8_t* data, int64_t n, int64_t* out) {
    int64_t h4[4][256] = {{0}};
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        h4[0][data[i]]++; h4[1][data[i + 1]]++;
        h4[2][data[i + 2]]++; h4[3][data[i + 3]]++;
    }
    for (; i < n; i++) h4[0][data[i]]++;
    for (int s = 0; s < 256; s++)
        out[s] = h4[0][s] + h4[1][s] + h4[2][s] + h4[3][s];
}

// codes = lut[data] packed `width` bits each, little-endian within a byte
// (pack_np(lut[a], width))
void gxz_pack_lut(const uint8_t* data, int64_t n, const uint8_t* lut,
                  int width, uint8_t* out) {
    int per = 8 / width;
    int64_t nb = (n + per - 1) / per;
    memset(out, 0, (size_t)nb);
    int64_t i = 0;
    if (width == 2) {
        int64_t n4 = n / 4;
        for (int64_t b = 0; b < n4; b++) {
            const uint8_t* p = data + b * 4;
            out[b] = (uint8_t)(lut[p[0]] | (lut[p[1]] << 2) |
                               (lut[p[2]] << 4) | (lut[p[3]] << 6));
        }
        i = n4 * 4;
    } else if (width == 4) {
        int64_t n2 = n / 2;
        for (int64_t b = 0; b < n2; b++) {
            const uint8_t* p = data + b * 2;
            out[b] = (uint8_t)(lut[p[0]] | (lut[p[1]] << 4));
        }
        i = n2 * 2;
    } else {
        int64_t n8 = n / 8;
        for (int64_t b = 0; b < n8; b++) {
            const uint8_t* p = data + b * 8;
            uint8_t v = 0;
            for (int k = 0; k < 8; k++) v |= (uint8_t)(lut[p[k]] << k);
            out[b] = v;
        }
        i = n8 * 8;
    }
    for (; i < n; i++)
        out[i / per] |= (uint8_t)(lut[data[i]] << ((i % per) * width));
}

// out[i] = syms[code i]; returns 0, or -1 when a code is >= nsyms (the
// numpy syms[codes] raises) or the packed bytes are short
int gxz_unpack_lut(const uint8_t* packed, int64_t packed_len, int64_t n,
                   int width, const uint8_t* syms, int nsyms, uint8_t* out) {
    int per = 8 / width;
    if (packed_len < (n + per - 1) / per) return -1;
    uint8_t mask = (uint8_t)((1 << width) - 1);
    uint8_t bad = 0;
    if (width == 2) {
        int64_t n4 = n / 4;
        for (int64_t b = 0; b < n4; b++) {
            uint8_t v = packed[b];
            for (int k = 0; k < 4; k++) {
                uint8_t c = (v >> (2 * k)) & 3;
                bad |= (uint8_t)(c >= nsyms);
                out[b * 4 + k] = syms[c & mask];
            }
        }
        for (int64_t i = n4 * 4; i < n; i++) {
            uint8_t c = (packed[i / 4] >> ((i % 4) * 2)) & 3;
            bad |= (uint8_t)(c >= nsyms);
            out[i] = syms[c];
        }
    } else {
        for (int64_t i = 0; i < n; i++) {
            uint8_t c = (packed[i / per] >> ((i % per) * width)) & mask;
            bad |= (uint8_t)(c >= nsyms);
            out[i] = syms[c];
        }
    }
    return bad ? -1 : 0;
}

// DNA 2-bit pack (ops/pack.seq_pack_2bit): codes 4 a byte, non-ACGT bytes
// to the exception channel (code 0). Returns the exception count.
int64_t gxz_acgt_pack(const uint8_t* seq, int64_t n, uint8_t* packed,
                      uint32_t* exc_pos, uint8_t* exc_bytes) {
    uint8_t code[256];
    memset(code, 0xFF, 256);
    code['A'] = 0; code['C'] = 1; code['G'] = 2; code['T'] = 3;
    int64_t ne = 0;
    int64_t nb = (n + 3) / 4;
    memset(packed, 0, (size_t)nb);
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = code[seq[i]];
        if (c == 0xFF) {
            exc_pos[ne] = (uint32_t)i;
            exc_bytes[ne++] = seq[i];
            c = 0;
        }
        packed[i >> 2] |= (uint8_t)(c << ((i & 3) * 2));
    }
    return ne;
}

// ops/pack.seq_unpack_2bit; -1 when the packed bytes are short or an
// exception position is outside [0, n)
int gxz_acgt_unpack(const uint8_t* packed, int64_t packed_len, int64_t n,
                    const int64_t* exc_pos, const uint8_t* exc_bytes,
                    int64_t ne, uint8_t* out) {
    static const uint8_t ACGT[4] = {'A', 'C', 'G', 'T'};
    if (packed_len < (n + 3) / 4) return -1;
    for (int64_t i = 0; i < n; i++)
        out[i] = ACGT[(packed[i >> 2] >> ((i & 3) * 2)) & 3];
    for (int64_t e = 0; e < ne; e++) {
        if (exc_pos[e] < 0 || exc_pos[e] >= n) return -1;
        out[exc_pos[e]] = exc_bytes[e];
    }
    return 0;
}

// inverse-BWT LF walk (codecs/bwt.bwt_inverse): the rows are 0..n
void gxz_bwt_walk(const int64_t* lf, const int64_t* li, int64_t prim,
                  int64_t n, uint8_t* out) {
    int64_t i = prim;
    for (int64_t k = n - 1; k >= 0; k--) {
        i = lf[i];
        out[k] = (uint8_t)(li[i] - 1);
    }
}

// PBWT (ops/pbwt.py): each row in the current order, then a stable counting
// sort of the order by the row. A is (n, H) row-major.
void gxz_pbwt_encode(const uint8_t* A, int64_t n, int64_t H, uint8_t* Y) {
    std::vector<int64_t> perm(H), nperm(H);
    for (int64_t j = 0; j < H; j++) perm[j] = j;
    std::vector<int64_t> cnt(257);
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = A + i * H;
        uint8_t* y = Y + i * H;
        for (int64_t j = 0; j < H; j++) y[j] = row[perm[j]];
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t j = 0; j < H; j++) cnt[y[j] + 1]++;
        for (int k = 1; k <= 256; k++) cnt[k] += cnt[k - 1];
        for (int64_t j = 0; j < H; j++) nperm[cnt[y[j]]++] = perm[j];
        perm.swap(nperm);
    }
}

void gxz_pbwt_decode(const uint8_t* Y, int64_t n, int64_t H, uint8_t* A) {
    std::vector<int64_t> perm(H), nperm(H);
    for (int64_t j = 0; j < H; j++) perm[j] = j;
    std::vector<int64_t> cnt(257);
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* y = Y + i * H;
        uint8_t* row = A + i * H;
        for (int64_t j = 0; j < H; j++) row[perm[j]] = y[j];
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t j = 0; j < H; j++) cnt[y[j] + 1]++;
        for (int k = 1; k <= 256; k++) cnt[k] += cnt[k - 1];
        for (int64_t j = 0; j < H; j++) nperm[cnt[y[j]]++] = perm[j];
        perm.swap(nperm);
    }
}

// ---------------------------------------------------------------------------
// BAM
// ---------------------------------------------------------------------------

// Walk the block_size chain: record offsets (from data) and the bytes of
// whole records (*consumed). Returns the record count.
int64_t gxz_bam_scan(const uint8_t* data, int64_t len, int64_t* offsets,
                     int64_t max_records, int64_t* consumed) {
    int64_t off = 0, cnt = 0;
    while (off + 4 <= len && cnt < max_records) {
        uint32_t block_size;
        memcpy(&block_size, data + off, 4);
        if (off + 4 + (int64_t)block_size > len) break;
        offsets[cnt++] = off;
        off += 4 + block_size;
    }
    *consumed = off;
    return cnt;
}

// 4-bit SEQ -> ASCII (BamDT._seq_ascii): row i is the l_seq[i] letters
// from nibble 2*offsets[i] on, read on past the row where it is short, as
// the numpy gather does; ok[i] = 0 when an odd row's pad nibble != 0.
// Returns the bytes written, or -1 when a row reads past the data.
int64_t gxz_nib_expand(const uint8_t* nib, int64_t nib_len,
                       const int64_t* offsets, const int64_t* lseq,
                       int64_t nrows, uint8_t* out, uint8_t* ok) {
    static const char NB[17] = "=ACMGRSVTWYHKDBN";
    uint8_t* o = out;
    for (int64_t i = 0; i < nrows; i++) {
        int64_t st = offsets[i];
        int64_t nb = offsets[i + 1] - st;
        int64_t L = lseq[i];
        if (L > 0 && st + ((L + 1) >> 1) > nib_len) return -1;
        const uint8_t* src = nib + st;
        int64_t pairs = L >> 1;
        for (int64_t k = 0; k < pairs; k++) {
            o[0] = (uint8_t)NB[src[k] >> 4];
            o[1] = (uint8_t)NB[src[k] & 15];
            o += 2;
        }
        if (L & 1) *o++ = (uint8_t)NB[src[pairs] >> 4];
        ok[i] = !((L & 1) && nb > 0 && (src[nb - 1] & 15) != 0);
    }
    return o - out;
}

// ASCII SEQ rows -> BAM nibble rows (BamDT._renibble), high nibble first
void gxz_renibble(const uint8_t* data, const int64_t* offsets, int64_t n,
                  const uint8_t* nib_of, uint8_t* out,
                  const int64_t* out_off) {
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* s = data + offsets[row];
        int64_t len = offsets[row + 1] - offsets[row];
        uint8_t* d = out + out_off[row];
        int64_t i = 0;
        for (; i + 1 < len; i += 2)
            d[i >> 1] = (uint8_t)((nib_of[s[i]] << 4) | nib_of[s[i + 1]]);
        if (i < len)
            d[i >> 1] = (uint8_t)(nib_of[s[i]] << 4);
    }
}

// ---------------------------------------------------------------------------
// SAM SEQ against the genome (datatypes/sam.py)
// ---------------------------------------------------------------------------

// One pass over the flat op table (_seg_seq_vs_ref): M/=/X bytes against
// the 2-bit genome, I/S bytes and whole rows that are not by reference into
// NONREF. Where is_set is given (REF_INTERNAL), every genome base compared
// while unset is marked in read_unset. Returns the mismatch count; writes at
// most mm_cap of them (the caller runs it again with room for all).
int64_t gxz_seq_diff(
    const uint8_t* seq, const int64_t* seq_off, int64_t n,
    const uint8_t* by_ref, const int64_t* gpos0,
    const uint8_t* letters, const int64_t* oplen, const int64_t* oprow,
    const int64_t* roff, const int64_t* goff, int64_t K,
    const uint8_t* ref_codes,
    const uint8_t* match_lut, const uint8_t* ins_lut,
    const uint8_t* base2bit, const uint8_t* is_acgt,
    const uint8_t* is_set, uint8_t* read_unset,
    int32_t* mm_row, int32_t* mm_pos, uint8_t* mm_base, int64_t mm_cap,
    uint8_t* nonref, int64_t* nonref_len) {
    int64_t mm = 0, nr = 0, k = 0;
    for (int64_t row = 0; row < n; row++) {
        int64_t soff = seq_off[row];
        if (!by_ref[row]) {
            int64_t len = seq_off[row + 1] - soff;
            memcpy(nonref + nr, seq + soff, (size_t)len);
            nr += len;
            while (k < K && oprow[k] == row) k++;
            continue;
        }
        int64_t g0 = gpos0[row];
        for (; k < K && oprow[k] == row; k++) {
            uint8_t lt = letters[k];
            int64_t len = oplen[k];
            if (match_lut[lt]) {
                const uint8_t* s = seq + soff + roff[k];
                int64_t g = g0 + goff[k];
                const uint8_t* r = ref_codes + g;
                int64_t rp = roff[k];
                if (is_set) {
                    for (int64_t i = 0; i < len; i++)
                        if (!is_set[g + i]) read_unset[g + i] = 1;
                }
                for (int64_t i = 0; i < len; i++) {
                    uint8_t b = s[i];
                    if (r[i] != base2bit[b] || !is_acgt[b]) {
                        if (mm < mm_cap) {
                            mm_row[mm] = (int32_t)row;
                            mm_pos[mm] = (int32_t)(rp + i);
                            mm_base[mm] = b;
                        }
                        mm++;
                    }
                }
            } else if (ins_lut[lt]) {
                memcpy(nonref + nr, seq + soff + roff[k], (size_t)len);
                nr += len;
            }
        }
    }
    *nonref_len = nr;
    return mm;
}

// Inverse of gxz_seq_diff (_recon_seq_vs_ref before its mismatch patches):
// match bytes from the genome (positions clipped to [0, G)) through the
// four-letter acgt table, I/S bytes and rows that are not by reference from
// NONREF. ins_before[k] = NONREF bytes of the row's earlier I/S ops.
// Returns 0, or -1 when a write or a NONREF read falls outside its buffer or
// a genome code is past the table (the numpy indexing raises there).
int gxz_seq_recon(
    uint8_t* out, int64_t out_len, const int64_t* out_off, int64_t n,
    const uint8_t* by_ref, const int64_t* gpos0,
    const uint8_t* letters, const int64_t* oplen, const int64_t* oprow,
    const int64_t* roff, const int64_t* goff, const int64_t* ins_before,
    int64_t K, const uint8_t* ref_codes, int64_t G, const uint8_t* acgt,
    const uint8_t* match_lut, const uint8_t* ins_lut,
    const uint8_t* nonref, int64_t nonref_len, const int64_t* nr_off) {
    int64_t k = 0;
    for (int64_t row = 0; row < n; row++) {
        int64_t o0 = out_off[row];
        if (!by_ref[row]) {
            int64_t len = out_off[row + 1] - o0;
            if (nr_off[row] < 0 || nr_off[row] + len > nonref_len) return -1;
            memcpy(out + o0, nonref + nr_off[row], (size_t)len);
            while (k < K && oprow[k] == row) k++;
            continue;
        }
        int64_t g0 = gpos0[row];
        for (; k < K && oprow[k] == row; k++) {
            uint8_t lt = letters[k];
            int64_t len = oplen[k];
            if (!match_lut[lt] && !ins_lut[lt]) continue;
            if (len < 0) return -1;
            int64_t d = o0 + roff[k];
            if (len > 0 && (d < 0 || d + len > out_len)) return -1;
            if (match_lut[lt]) {
                int64_t g = g0 + goff[k];
                for (int64_t i = 0; i < len; i++) {
                    int64_t gi = g + i;
                    if (gi < 0) gi = 0;
                    else if (gi >= G) gi = G - 1;
                    if (ref_codes[gi] > 3) return -1;
                    out[d + i] = acgt[ref_codes[gi]];
                }
            } else {
                int64_t s = nr_off[row] + ins_before[k];
                if (len > 0 && (s < 0 || s + len > nonref_len)) return -1;
                memcpy(out + d, nonref + s, (size_t)len);
            }
        }
    }
    return 0;
}

// REF_INTERNAL population (_populate_internal_ref): each read of the batch
// writes its bases where the genome was unset before the batch and no
// earlier VB was diffed against it unset (read_unset, may be null); where
// reads overlap the last one wins, as numpy's fancy assignment does. Then
// blk_set is recounted for each touched block of `blk` bases. is_set must
// be padded to whole blocks.
void gxz_ref_populate(
    const uint8_t* seq, const int64_t* seq_off,
    const int64_t* rows, const int64_t* starts, int64_t nrows,
    const uint8_t* base2bit, uint8_t* ref_codes, uint8_t* is_set,
    const uint8_t* read_unset, int64_t* blk_set, int64_t nblk, int64_t blk) {
    // 2 marks "set in this batch" until the recount
    for (int64_t i = 0; i < nrows; i++) {
        int64_t row = rows[i];
        const uint8_t* s = seq + seq_off[row];
        int64_t len = seq_off[row + 1] - seq_off[row];
        int64_t g = starts[i];
        for (int64_t j = 0; j < len; j++) {
            int64_t gj = g + j;
            if (is_set[gj] == 1 || (read_unset && read_unset[gj])) continue;
            ref_codes[gj] = base2bit[s[j]];
            is_set[gj] = 2;
        }
    }
    std::vector<uint8_t> touched(nblk, 0);
    for (int64_t i = 0; i < nrows; i++) {
        int64_t row = rows[i];
        int64_t len = seq_off[row + 1] - seq_off[row];
        int64_t g = starts[i];
        for (int64_t j = 0; j < len; j++)
            if (is_set[g + j] == 2) {
                is_set[g + j] = 1;
                touched[(g + j) / blk] = 1;
            }
    }
    for (int64_t b = 0; b < nblk; b++) {
        if (!touched[b]) continue;
        int64_t c = 0;
        const uint8_t* p = is_set + b * blk;
        for (int64_t j = 0; j < blk; j++) c += p[j];
        blk_set[b] = c;
    }
}

// ---------------------------------------------------------------------------
// Ragged columns (utils/ragged.py, seg.py, contexts.py)
// ---------------------------------------------------------------------------

// Row i: copy lens[i] bytes from src + src_starts[i] to dst + dst_starts[i].
// packed: the rows are written in order, each where the one before ends (a
// gather), so a row of up to 16 bytes is copied as 16 and the next rows
// overwrite the spill. Returns 0, or -1 when a range falls outside its
// buffer (nothing is copied then).
int gxz_copy_ranges(const uint8_t* src, const int64_t* src_starts,
                    uint8_t* dst, const int64_t* dst_starts,
                    const int64_t* lens, int64_t n,
                    int64_t src_size, int64_t dst_size, int packed) {
    for (int64_t i = 0; i < n; i++) {
        int64_t l = lens[i], ss = src_starts[i], ds = dst_starts[i];
        if (l < 0 || (l > 0 && (ss < 0 || ss + l > src_size || ds < 0 ||
                                ds + l > dst_size)))
            return -1;
    }
    if (packed) {
        for (int64_t i = 0; i < n; i++) {
            int64_t l = lens[i], ss = src_starts[i], ds = dst_starts[i];
            if (l <= 16 && ss + 16 <= src_size && ds + 16 <= dst_size)
                memcpy(dst + ds, src + ss, 16);
            else
                memcpy(dst + ds, src + ss, (size_t)l);
        }
        return 0;
    }
    for (int64_t i = 0; i < n; i++)
        memcpy(dst + dst_starts[i], src + src_starts[i], (size_t)lens[i]);
    return 0;
}

// per-row count of bytes equal to sep
void gxz_count_eq(const uint8_t* data, const int64_t* off, int64_t n,
                  uint8_t sep, int64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t c = 0;
        const uint8_t* p = data + off[i];
        const uint8_t* e = data + off[i + 1];
        for (; p < e; p++) c += (*p == sep);
        out[i] = c;
    }
}

// ragged.atoi: optional '-' (on rows longer than one byte), 1..19 digits,
// no leading zero on a multi-digit value; int64 arithmetic wraps. A row
// that does not parse gets ok = 0 and the value numpy computes for it: the
// fold v = 10 v + (c - '0') over its last min(digits, 19) bytes.
void gxz_atoi(const uint8_t* data, int64_t data_len, const int64_t* offsets,
              int64_t n, int64_t* vals, uint8_t* ok) {
    for (int64_t i = 0; i < n; i++) {
        int64_t st = offsets[i];
        int64_t len = offsets[i + 1] - st;
        bool neg = len > 1 && data[st] == '-';
        int64_t dl = len - neg;
        int64_t use = dl < 19 ? dl : 19;
        int64_t p = st + neg + (dl - use);
        uint64_t v = 0;
        bool digits = true;
        for (int64_t j = 0; j < use; j++) {
            int64_t q = p + j;
            if (q >= data_len) q = data_len - 1;
            if (q < 0) q = 0;
            uint8_t c = data[q];
            digits &= c >= '0' && c <= '9';
            v = v * 10 + (uint64_t)((int64_t)c - '0');
        }
        vals[i] = (int64_t)(neg ? 0ULL - v : v);
        ok[i] = dl >= 1 && dl <= 19 && digits &&
                !(dl > 1 && data[p] == '0');
    }
}

// int64 rows -> decimal ASCII. out = null: fill offsets and return the
// total; then fill out.
int64_t gxz_itoa(const int64_t* vals, int64_t n, int64_t* offsets,
                 uint8_t* out) {
    if (!out) {
        int64_t total = 0;
        offsets[0] = 0;
        for (int64_t i = 0; i < n; i++) {
            uint64_t a = vals[i] < 0 ? (uint64_t)(-(vals[i] + 1)) + 1
                                     : (uint64_t)vals[i];
            int nd = 1;
            for (uint64_t t = a / 10; t; t /= 10) nd++;
            total += nd + (vals[i] < 0);
            offsets[i + 1] = total;
        }
        return total;
    }
    for (int64_t i = 0; i < n; i++) {
        uint64_t a = vals[i] < 0 ? (uint64_t)(-(vals[i] + 1)) + 1
                                 : (uint64_t)vals[i];
        uint8_t* end = out + offsets[i + 1];
        do { *--end = (uint8_t)('0' + a % 10); a /= 10; } while (a);
        if (vals[i] < 0) *--end = '-';
    }
    return offsets[n];
}

// Tokenizer scan (seg._tokenize_np): per row, each digit run of <= 18
// bytes, up to max_tokens a row, becomes 0x01 in the template, its value
// and width emitted row-major. Returns the value count; *tmpl_total gets
// the template bytes.
int64_t gxz_tokenize(const uint8_t* data, const int64_t* row_off, int64_t nrows,
                     int64_t max_tokens, uint8_t* tmpl, int64_t* tmpl_lens,
                     int64_t* values, int32_t* tok_idx, int64_t* tmpl_total,
                     uint8_t* widths) {
    int64_t nv = 0;
    int64_t tp = 0;
    for (int64_t r = 0; r < nrows; r++) {
        const uint8_t* p = data + row_off[r];
        int64_t len = row_off[r + 1] - row_off[r];
        int64_t tstart = tp;
        int64_t tok = 0;
        int64_t i = 0;
        while (i < len) {
            uint8_t c = p[i];
            if (c >= '0' && c <= '9') {
                int64_t j = i + 1;
                while (j < len && p[j] >= '0' && p[j] <= '9') j++;
                int64_t rl = j - i;
                if (rl <= 18 && tok < max_tokens) {
                    int64_t v = 0;
                    for (int64_t k = i; k < j; k++) v = v * 10 + (p[k] - '0');
                    values[nv] = v;
                    widths[nv] = (uint8_t)rl;
                    tok_idx[nv++] = (int32_t)tok++;
                    tmpl[tp++] = 0x01;
                } else {
                    memcpy(tmpl + tp, p + i, (size_t)rl);
                    tp += rl;
                }
                i = j;
            } else {
                tmpl[tp++] = c;
                i++;
            }
        }
        tmpl_lens[r] = tp - tstart;
    }
    *tmpl_total = tp;
    return nv;
}

// 64-bit row hash of a ragged column (8-byte blocks and a mix), for dedup
// (collisions are caught by gxz_rows_equal_rep) and dict membership
void gxz_row_hash(const uint8_t* data, const int64_t* offsets, int64_t n,
                  uint64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t p = offsets[i], end = offsets[i + 1];
        uint64_t h = 0x9E3779B97F4A7C15ull ^ (uint64_t)(end - p);
        while (p + 8 <= end) {
            uint64_t w;
            memcpy(&w, data + p, 8);
            h = (h ^ w) * 0x100000001B3ull;
            h ^= h >> 29;
            p += 8;
        }
        uint64_t w = 0;
        for (int j = 0; p < end; p++, j += 8) w |= (uint64_t)data[p] << j;
        h = (h ^ w) * 0x100000001B3ull;
        h ^= h >> 31;
        h *= 0xBF58476D1CE4E5B9ull;
        h ^= h >> 29;
        out[i] = h;
    }
}

// 1 if every row equals its representative row (rep[i] = row index)
int gxz_rows_equal_rep(const uint8_t* data, const int64_t* offsets,
                       const int64_t* rep, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = rep[i];
        int64_t la = offsets[i + 1] - offsets[i];
        int64_t lb = offsets[r + 1] - offsets[r];
        if (la != lb) return 0;
        if (la && memcmp(data + offsets[i], data + offsets[r], (size_t)la))
            return 0;
    }
    return 1;
}

// In-place reverse (and complement through lut, may be null) of the rows
void gxz_reverse_rows(uint8_t* data, const int64_t* offsets,
                      const int64_t* rows, int64_t nrows,
                      const uint8_t* comp_lut) {
    for (int64_t i = 0; i < nrows; i++) {
        int64_t row = rows[i];
        if (offsets[row + 1] <= offsets[row]) continue;
        uint8_t* a = data + offsets[row];
        uint8_t* b = data + offsets[row + 1] - 1;
        if (comp_lut) {
            while (a < b) {
                uint8_t x = comp_lut[*a], y = comp_lut[*b];
                *a++ = y; *b-- = x;
            }
            if (a == b) *a = comp_lut[*a];
        } else {
            while (a < b) { uint8_t x = *a; *a++ = *b; *b-- = x; }
        }
    }
}

// Byte offset just past the last newline whose 1-based ordinal is a
// multiple of `stride` (FASTQ record alignment); 0 if none
int64_t gxz_stride_boundary(const uint8_t* data, int64_t len, int64_t stride) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    int64_t cnt = 0, last = -1;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        if (!q) break;
        if ((++cnt % stride) == 0) last = q - data;
        p = q + 1;
    }
    return last + 1;
}

// ---------------------------------------------------------------------------
// VCF helpers (datatypes/vcf.py)
// ---------------------------------------------------------------------------

// Per-row stats of "int(,int)*" lists (_ad_sums, _pl_gq): sum (accumulated
// in double and truncated, as np.bincount(weights=).astype(int64) does),
// lowest, second lowest (a repeated lowest counts twice), value count, ok.
// Rows that do not parse: 0, INT64_MAX, INT64_MAX, 0, 0.
void gxz_int_list_stats(const uint8_t* data, const int64_t* offsets,
                        int64_t C, int64_t* sums, int64_t* min1,
                        int64_t* min2, int32_t* nvals, uint8_t* ok) {
    for (int64_t i = 0; i < C; i++) {
        double s = 0.0;
        int64_t m1 = INT64_MAX, m2 = INT64_MAX;
        int32_t k = 0;
        bool good = parse_int_list(data, offsets[i], offsets[i + 1],
                                   [&](int64_t v) {
            k++;
            s += (double)v;
            if (v < m1) { m2 = m1; m1 = v; }
            else if (v < m2) m2 = v;
        });
        if (good) {
            sums[i] = s < 9223372036854775808.0 ? (int64_t)s : INT64_MIN;
            min1[i] = m1; min2[i] = m2;
            nvals[i] = k; ok[i] = 1;
        } else {
            sums[i] = 0; min1[i] = INT64_MAX; min2[i] = INT64_MAX;
            nvals[i] = 0; ok[i] = 0;
        }
    }
}

// Values of the rows that parse, in row order; nvals[i] = their count (0
// where the row does not parse). vals needs (comma count + C) entries;
// total[0] = values written.
void gxz_int_list_parse(const uint8_t* data, const int64_t* offsets,
                        int64_t C, int64_t* vals, int32_t* nvals,
                        uint8_t* ok, int64_t* total) {
    int64_t w = 0;
    for (int64_t i = 0; i < C; i++) {
        int64_t w0 = w;
        int32_t k = 0;
        bool good = parse_int_list(data, offsets[i], offsets[i + 1],
                                   [&](int64_t v) { vals[w++] = v; k++; });
        if (good) {
            nvals[i] = k; ok[i] = 1;
        } else {
            w = w0;
            nvals[i] = 0; ok[i] = 0;
        }
    }
    total[0] = w;
}

// Split each row on sep into at most T fields: field t of row i goes to
// f_start[t*C+i] / f_len[t*C+i]; nfields[i] = the field count, T + 1 when
// there are more than T, 0 for an empty row.
void gxz_split_fields(const uint8_t* data, const int64_t* offsets, int64_t C,
                      uint8_t sep, int T, int64_t* f_start, int32_t* f_len,
                      int32_t* nfields) {
    memset(f_len, 0, (size_t)T * (size_t)C * 4);
    memset(f_start, 0, (size_t)T * (size_t)C * 8);
    for (int64_t i = 0; i < C; i++) {
        int64_t p = offsets[i], end = offsets[i + 1];
        if (p == end) { nfields[i] = 0; continue; }
        int t = 0;
        int64_t st = p;
        while (p < end && t < T) {
            if (data[p] == sep) {
                f_start[(size_t)t * C + i] = st;
                f_len[(size_t)t * C + i] = (int32_t)(p - st);
                t++;
                st = p + 1;
            }
            p++;
        }
        if (t < T) {
            f_start[(size_t)t * C + i] = st;
            f_len[(size_t)t * C + i] = (int32_t)(end - st);
            nfields[i] = t + 1;
        } else {
            nfields[i] = T + 1;
        }
    }
}

// Cell i = its nsub[i] consecutive subfields joined by sep; out holds
// sum(lens) + sum(max(nsub - 1, 0)) bytes, cell_off C + 1 offsets.
void gxz_join_cells(const uint8_t* data, const int64_t* offsets,
                    const int32_t* nsub, int64_t C, uint8_t sep,
                    uint8_t* out, int64_t* cell_off) {
    int64_t w = 0, s = 0;
    cell_off[0] = 0;
    for (int64_t i = 0; i < C; i++) {
        int32_t k = nsub[i];
        for (int32_t j = 0; j < k; j++, s++) {
            int64_t len = offsets[s + 1] - offsets[s];
            memcpy(out + w, data + offsets[s], (size_t)len);
            w += len;
            if (j + 1 < k) out[w++] = sep;
        }
        cell_off[i + 1] = w;
    }
}

// ---------------------------------------------------------------------------
// XXH64, for the "x64" VB digest that genozip_tpu writes with its native
// runtime (checked on PIZ; the port never writes it)
// ---------------------------------------------------------------------------
uint64_t gxz_xxh64(uint64_t seed, const uint8_t* p, int64_t len) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed,
                 v4 = seed - XP1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xround(v1, xread64(p)); p += 8;
            v2 = xround(v2, xread64(p)); p += 8;
            v3 = xround(v3, xread64(p)); p += 8;
            v4 = xround(v4, xread64(p)); p += 8;
        } while (p <= limit);
        h = xrotl(v1, 1) + xrotl(v2, 7) + xrotl(v3, 12) + xrotl(v4, 18);
        h = xmerge(h, v1); h = xmerge(h, v2);
        h = xmerge(h, v3); h = xmerge(h, v4);
    } else {
        h = seed + XP5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= xround(0, xread64(p));
        h = xrotl(h, 27) * XP1 + XP4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)xread32(p) * XP1;
        h = xrotl(h, 23) * XP2 + XP3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p++) * XP5;
        h = xrotl(h, 11) * XP1;
    }
    h ^= h >> 33; h *= XP2; h ^= h >> 29; h *= XP3; h ^= h >> 32;
    return h;
}

}  // extern "C"

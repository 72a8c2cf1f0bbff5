// Native host engine: SEAL-class C++ implementation of the BFV ops.
//
// Role in the framework (SURVEY.md section 2.2): the reference delegates all
// FHE math to Microsoft SEAL (C++).  Our canonical semantics live in
// bfv/golden.py (numpy) and the accelerated path in ops/engine.py (JAX/TPU);
// this file is the third engine -- a from-scratch C++ mirror of the golden
// model for CPU validators, where numpy's emulated-u64 modular arithmetic
// leaves ~20-50x on the table.  Every function reproduces the corresponding
// golden.py method bit-for-bit (asserted by tests/test_native_engine.py).
//
// Design notes
//  * All moduli are < 2**37 (params.py validate()), so a*b < 2**74 fits
//    unsigned __int128 and a per-modulus Barrett reduction with shift
//    b = bitlen(p) is exact after <= 2 conditional subtractions.
//  * NTT: negacyclic Cooley-Tukey forward / Gentleman-Sande inverse with
//    twiddles in bit-reversed (Longa-Naehrig) layout and Shoup-precomputed
//    companions -- the same tables and stage indexing as bfv/ntt.py, so
//    "NTT form" arrays are interchangeable across engines.
//  * The context derives every BEHZ/CRT constant itself from
//    (n, t, q_mods, key_mods, B, m_sk, m_tilde) -- the same derivations as
//    BfvContext.__init__ (golden.py:89-151) -- rather than importing them,
//    so the library is a standalone native engine, not a Python wrapper.
//  * Decrypt's scale-and-round uses exact wide arithmetic (u128/u192),
//    matching golden._message_from_dot's bigint CRT exactly (including on
//    garbage ciphertexts, where the division-free t-gamma approximation
//    used by the TPU path could differ on ~2^-16 of coefficients).
//
// Bounds assumed (asserted at ctx creation): k <= 4 ciphertext limbs with
// q = prod(ct_moduli) < 2**122 and t*q < 2**160 (u192 headroom); all
// moduli < 2**37.

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#define HE_HAVE_AVX512 1
// AVX-512 IFMA (vpmadd52) gives 52x52->104-bit multiply-add: with all moduli
// < 2^37 (lazy values < 4p < 2^39), Harvey butterflies with beta = 2^52
// Shoup constants fit entirely in the 52-bit domain -- the same observation
// Intel HEXL builds on.  Compiled with per-function target attributes and
// dispatched at runtime, so the .so stays portable to non-AVX512 hosts.
#define HE_AVX512_FN \
    __attribute__((target("avx512f,avx512dq,avx512vl,avx512ifma")))
#endif

typedef uint64_t u64;
typedef int64_t i64;
typedef unsigned __int128 u128;
typedef __int128 i128;

namespace {

// ---------------------------------------------------------------------------
// scalar modular helpers
// ---------------------------------------------------------------------------

static inline u64 addmod(u64 a, u64 b, u64 p) {
    u64 s = a + b;                 // a,b < p < 2^37: no u64 overflow
    return s >= p ? s - p : s;
}

static inline u64 submod(u64 a, u64 b, u64 p) {
    return a >= b ? a - b : a + (p - b);
}

static inline u64 negmod(u64 a, u64 p) { return a == 0 ? 0 : p - a; }

static u64 powmod(u64 base, u64 exp, u64 p) {
    u128 acc = 1, b = base % p;
    while (exp) {
        if (exp & 1) acc = acc * b % p;
        b = b * b % p;
        exp >>= 1;
    }
    return (u64)acc;
}

// Modular inverse via extended Euclid (works for non-prime moduli too,
// e.g. inverses mod m_tilde = 2^16; golden.py uses pow(a, -1, p)).
static u64 invmod(u64 a, u64 p) {
    i128 t = 0, newt = 1;
    i128 r = (i128)p, newr = (i128)(a % p);
    while (newr != 0) {
        i128 q = r / newr;
        i128 tmp = t - q * newt; t = newt; newt = tmp;
        tmp = r - q * newr; r = newr; newr = tmp;
    }
    if (r != 1) return 0;  // not invertible; callers guarantee it is
    if (t < 0) t += p;
    return (u64)t;
}

// Floored modulus of a signed value (numpy np.mod semantics).
static inline u64 fmod_signed(i64 v, u64 p) {
    i64 m = v % (i64)p;
    if (m < 0) m += (i64)p;
    return (u64)m;
}

// Per-modulus Barrett state: exact (a*b) % p for a, b < p < 2^37, plus a
// full-u64 -> mod-p pre-reduction for cross-base residues (fastbconv feeds
// values < q_i into a *different* target modulus x, possibly q_i > x).
struct Barrett {
    u64 p = 0;
    unsigned b = 0;   // bitlen(p)
    u64 mu = 0;       // floor(2^(2b) / p) < 2^(b+1)
    u64 mu64 = 0;     // floor(2^64 / p)   (requires p >= 2^10 to be useful)

    void init(u64 p_) {
        p = p_;
        b = 64 - __builtin_clzll(p);
        mu = (u64)((((u128)1) << (2 * b)) / p);
        mu64 = (u64)(((u128)1 << 64) / p);
    }
    inline u64 reduce(u128 x) const {        // x < 2^(2b)
        u64 qhat = (u64)(((u128)(u64)(x >> b) * mu) >> b);
        u64 r = (u64)(x - (u128)qhat * p);
        while (r >= p) r -= p;
        return r;
    }
    inline u64 mul(u64 a, u64 c) const { return reduce((u128)a * c); }
    inline u64 reduce64(u64 y) const {       // any y < 2^64 -> y mod p
        u64 qhat = (u64)(((u128)y * mu64) >> 64);
        u64 r = y - qhat * p;                // error <= 2
        while (r >= p) r -= p;
        return r;
    }
};

// Shoup multiply: (x * w) % p with precomputed ws = floor(w * 2^64 / p).
static inline u64 shoup_mul(u64 x, u64 w, u64 ws, u64 p) {
    u64 qhat = (u64)(((u128)x * ws) >> 64);
    u64 r = x * w - qhat * p;     // in [0, 2p)
    return r >= p ? r - p : r;
}

static inline u64 shoup_precompute(u64 w, u64 p) {
    return (u64)((((u128)w) << 64) / p);
}

// ---------------------------------------------------------------------------
// u192 helpers (only used by decrypt's exact scale-and-round)
// ---------------------------------------------------------------------------

struct u192 { u64 w0, w1, w2; };   // w0 least significant

static inline u192 u192_from_u128(u128 x) {
    return {(u64)x, (u64)(x >> 64), 0};
}

static inline u192 u192_add(u192 a, u192 b) {
    u192 r;
    unsigned char c = 0;
    c = __builtin_add_overflow(a.w0, b.w0, &r.w0);
    u64 t;
    unsigned char c1 = __builtin_add_overflow(a.w1, b.w1, &t);
    unsigned char c2 = __builtin_add_overflow(t, (u64)c, &r.w1);
    r.w2 = a.w2 + b.w2 + (u64)(c1 | c2);
    return r;
}

static inline bool u192_geq(u192 a, u192 b) {
    if (a.w2 != b.w2) return a.w2 > b.w2;
    if (a.w1 != b.w1) return a.w1 > b.w1;
    return a.w0 >= b.w0;
}

static inline u192 u192_sub(u192 a, u192 b) {   // requires a >= b
    u192 r;
    unsigned char brw = __builtin_sub_overflow(a.w0, b.w0, &r.w0);
    u64 t;
    unsigned char b1 = __builtin_sub_overflow(a.w1, b.w1, &t);
    unsigned char b2 = __builtin_sub_overflow(t, (u64)brw, &r.w1);
    r.w2 = a.w2 - b.w2 - (u64)(b1 | b2);
    return r;
}

// small (< 2^40) * u128 -> u192
static inline u192 u192_mul_small(u64 s, u128 x) {
    u128 lo = (u128)s * (u64)x;
    u128 hi = (u128)s * (u64)(x >> 64);
    u192 r;
    r.w0 = (u64)lo;
    u128 mid = (lo >> 64) + (u64)hi;
    r.w1 = (u64)mid;
    r.w2 = (u64)(hi >> 64) + (u64)(mid >> 64);
    return r;
}

// floor(N / q) for quotient < 2^48: float estimate + exact correction.
static inline u64 u192_div_u128_small(u192 N, u128 q) {
    long double nf = (long double)N.w2 * 340282366920938463463374607431768211456.0L  /* 2^128 */
                   + (long double)N.w1 * 18446744073709551616.0L                      /* 2^64 */
                   + (long double)N.w0;
    long double qf = (long double)(u64)(q >> 64) * 18446744073709551616.0L
                   + (long double)(u64)q;
    u64 est = (u64)(nf / qf);
    // correct: find exact floor around the estimate
    u192 prod = u192_mul_small(est, q);
    while (!u192_geq(N, prod)) {            // est too big
        est--;
        prod = u192_mul_small(est, q);
    }
    u192 rem = u192_sub(N, prod);
    u192 qq = u192_from_u128(q);
    while (u192_geq(rem, qq)) {             // est too small
        est++;
        rem = u192_sub(rem, qq);
    }
    return est;
}

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693, unkeyed, 64-byte digest) + the framework's counter-mode
// XOF and samplers.  Must match sampling.py byte-for-byte: block_i =
// BLAKE2b-64(seed || le64(domain) || le64(i)); ternary via 2-bit rejection;
// CBD via MSB-first bit unpacking (np.unpackbits order).
// ---------------------------------------------------------------------------

namespace blake2b {

static const u64 IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline u64 rotr64(u64 x, int r) { return (x >> r) | (x << (64 - r)); }

static inline void G(u64* v, int a, int b, int cc, int d, u64 x, u64 y) {
    v[a] = v[a] + v[b] + x;
    v[d] = rotr64(v[d] ^ v[a], 32);
    v[cc] = v[cc] + v[d];
    v[b] = rotr64(v[b] ^ v[cc], 24);
    v[a] = v[a] + v[b] + y;
    v[d] = rotr64(v[d] ^ v[a], 16);
    v[cc] = v[cc] + v[d];
    v[b] = rotr64(v[b] ^ v[cc], 63);
}

static inline u64 load_le64(const uint8_t* p) {
    u64 x;
    std::memcpy(&x, p, 8);           // little-endian hosts (x86/arm64)
    return x;
}

static inline void store_le64(uint8_t* p, u64 x) { std::memcpy(p, &x, 8); }

// Single-block hash of a message with len <= 128 (all our inputs are 80 B).
static void hash64(const uint8_t* msg, size_t len, uint8_t out[64]) {
    u64 h[8];
    for (int i = 0; i < 8; ++i) h[i] = IV[i];
    h[0] ^= 0x01010040ULL;           // digest 64, key 0, fanout 1, depth 1
    uint8_t block[128] = {0};
    std::memcpy(block, msg, len);
    u64 m[16], v[16];
    for (int i = 0; i < 16; ++i) m[i] = load_le64(block + 8 * i);
    for (int i = 0; i < 8; ++i) { v[i] = h[i]; v[i + 8] = IV[i]; }
    v[12] ^= (u64)len;               // t0 = total bytes
    v[14] = ~v[14];                  // final block flag
    for (int r = 0; r < 12; ++r) {
        const uint8_t* s = SIGMA[r];
        G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; ++i) store_le64(out + 8 * i, h[i] ^ v[i] ^ v[i + 8]);
}

}  // namespace blake2b

// Counter-mode XOF over BLAKE2b blocks, stateful leftover buffer --
// identical stream to sampling.Blake2Xof.read().
struct Xof {
    uint8_t msg[80];                 // seed(64) || le64(domain) || le64(ctr)
    u64 counter = 0;
    std::vector<uint8_t> buf;

    Xof(const uint8_t* seed, u64 domain) {
        std::memcpy(msg, seed, 64);
        blake2b::store_le64(msg + 64, domain);
    }
    void read(uint8_t* out, size_t nbytes) {
        size_t have = buf.size();
        std::vector<uint8_t> data(std::move(buf));
        buf.clear();
        data.reserve(have + ((nbytes > have ? nbytes - have : 0) + 63) + 64);
        while (have < nbytes) {
            blake2b::store_le64(msg + 72, counter);
            ++counter;
            uint8_t block[64];
            blake2b::hash64(msg, 80, block);
            data.insert(data.end(), block, block + 64);
            have += 64;
        }
        std::memcpy(out, data.data(), nbytes);
        buf.assign(data.begin() + nbytes, data.end());
    }
};

// ---------------------------------------------------------------------------
// NTT tables (bit-reversed Longa-Naehrig layout; golden bfv/modmath.py)
// ---------------------------------------------------------------------------

// Minimal primitive 2n-th root of unity mod p (SEAL convention;
// golden modmath.minimal_primitive_root).
static u64 minimal_primitive_root(u64 two_n, u64 p) {
    u64 exp = (p - 1) / two_n;
    u64 root = 0;
    for (u64 g = 2; g < 10000; ++g) {
        u64 r = powmod(g, exp, p);
        if (powmod(r, two_n / 2, p) != 1) { root = r; break; }
    }
    if (!root) return 0;
    // minimum over all odd powers of root
    u128 root_sq = (u128)root * root % p;
    u128 cur = root; u64 best = root;
    for (u64 i = 0; i < two_n / 2; ++i) {
        if ((u64)cur < best) best = (u64)cur;
        cur = cur * root_sq % p;
    }
    return best;
}

static u64 bit_reverse(u64 x, unsigned bits) {
    u64 r = 0;
    for (unsigned i = 0; i < bits; ++i) { r = (r << 1) | (x & 1); x >>= 1; }
    return r;
}

// 52-bit Shoup companion: floor(w * 2^52 / p).  Exact for x < 2^52, w < p
// (same analysis as the 64-bit version with beta = 2^52).
static inline u64 shoup52_precompute(u64 w, u64 p) {
    return (u64)((((u128)w) << 52) / p);
}

struct Table {
    u64 p = 0;
    Barrett br;
    u64 n = 0;
    unsigned logn = 0;
    std::vector<u64> w, ws;     // root_powers + Shoup companions
    std::vector<u64> iw, iws;   // inverse root powers + Shoup
    u64 n_inv = 0, n_inv_s = 0;
    // AVX-512 IFMA side tables (beta = 2^52 Shoup companions, plus
    // lane-ordered twiddles for the three butterfly stages whose block
    // half-width t < 8 and therefore straddles a single zmm register).
    std::vector<u64> ws52, iws52;
    u64 n_inv_s52 = 0;
    std::vector<u64> lane_w[3], lane_ws52[3];    // forward, t = 4,2,1
    std::vector<u64> lane_iw[3], lane_iws52[3];  // inverse, t = 4,2,1

    bool init(u64 p_, u64 n_) {
        p = p_; n = n_;
        br.init(p);
        logn = (unsigned)(63 - __builtin_clzll(n));
        if ((p - 1) % (2 * n) != 0) return false;
        u64 psi = minimal_primitive_root(2 * n, p);
        if (!psi) return false;
        std::vector<u64> pows(n);
        u128 acc = 1;
        for (u64 i = 0; i < n; ++i) { pows[i] = (u64)acc; acc = acc * psi % p; }
        w.resize(n); ws.resize(n); iw.resize(n); iws.resize(n);
        ws52.resize(n); iws52.resize(n);
        for (u64 i = 0; i < n; ++i) {
            u64 v = pows[bit_reverse(i, logn)];
            w[i] = v;
            ws[i] = shoup_precompute(v, p);
            ws52[i] = shoup52_precompute(v, p);
            u64 vi = invmod(v, p);
            iw[i] = vi;
            iws[i] = shoup_precompute(vi, p);
            iws52[i] = shoup52_precompute(vi, p);
        }
        n_inv = invmod(n % p, p);
        n_inv_s = shoup_precompute(n_inv, p);
        n_inv_s52 = shoup52_precompute(n_inv, p);
        // Lane-ordered twiddles: at stage (m, t) the butterfly containing
        // index i uses twiddle index m + i/(2t); materializing that per
        // lane lets the t<8 stages run as uniform blended vector code.
        if (n >= 8) {
            for (unsigned lt = 0; lt < 3; ++lt) {     // lt = log2(t)
                const u64 t = 1ull << lt, m = n / (2 * t);
                lane_w[lt].resize(n); lane_ws52[lt].resize(n);
                lane_iw[lt].resize(n); lane_iws52[lt].resize(n);
                for (u64 i = 0; i < n; ++i) {
                    const u64 idx = m + i / (2 * t);
                    lane_w[lt][i] = w[idx];
                    lane_ws52[lt][i] = ws52[idx];
                    lane_iw[lt][i] = iw[idx];
                    lane_iws52[lt][i] = iws52[idx];
                }
            }
        }
        return true;
    }
};

#ifdef HE_HAVE_AVX512
// ---------------------------------------------------------------------------
// AVX-512 IFMA NTT (Harvey lazy butterflies, beta = 2^52 Shoup arithmetic)
//
// Bit-exactness: every butterfly computes the same value mod p as the scalar
// path; values are kept lazily in [0, 4p) (forward) / [0, 2p) (inverse) and
// canonicalized at the end, so the output arrays are identical byte-for-byte
// to ntt_inplace/intt_inplace (asserted across all ops by
// tests/test_native_engine.py).
// ---------------------------------------------------------------------------

// (x * w) mod-ish p via 52-bit Shoup: returns value in [0, 2p), exact for
// x < 2^52, w < p.  q = hi52(x * ws); T = (x*w - q*p) mod 2^52.
HE_AVX512_FN static inline __m512i shoup52v(__m512i x, __m512i w, __m512i ws,
                                            __m512i p, __m512i mask52) {
    const __m512i z = _mm512_setzero_si512();
    __m512i q = _mm512_madd52hi_epu64(z, x, ws);
    __m512i t = _mm512_sub_epi64(_mm512_madd52lo_epu64(z, x, w),
                                 _mm512_madd52lo_epu64(z, q, p));
    return _mm512_and_si512(t, mask52);
}

// Partner-exchange permutation for block half-width t in {4, 2, 1}.
HE_AVX512_FN static inline __m512i swap_t(__m512i x, u64 t) {
    if (t == 4) return _mm512_shuffle_i64x2(x, x, _MM_SHUFFLE(1, 0, 3, 2));
    if (t == 2) return _mm512_shuffle_i64x2(x, x, _MM_SHUFFLE(2, 3, 0, 1));
    __m512d xd = _mm512_castsi512_pd(x);
    return _mm512_castpd_si512(_mm512_shuffle_pd(xd, xd, 0x55));
}

HE_AVX512_FN static void ntt_avx512(const Table& tb, u64* a) {
    const u64 p = tb.p, n = tb.n;
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i v2p = _mm512_set1_epi64((long long)(2 * p));
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    u64 m = 1, t = n >> 1;
    for (; t >= 8; m <<= 1, t >>= 1) {
        for (u64 blk = 0; blk < m; ++blk) {
            const __m512i wv = _mm512_set1_epi64((long long)tb.w[m + blk]);
            const __m512i wsv = _mm512_set1_epi64((long long)tb.ws52[m + blk]);
            u64* lo = a + blk * 2 * t;
            u64* hi = lo + t;
            for (u64 j = 0; j < t; j += 8) {
                __m512i X = _mm512_loadu_si512(lo + j);
                __m512i Y = _mm512_loadu_si512(hi + j);
                __mmask8 ge = _mm512_cmpge_epu64_mask(X, v2p);
                X = _mm512_mask_sub_epi64(X, ge, X, v2p);   // X < 2p
                __m512i T = shoup52v(Y, wv, wsv, vp, mask52);  // < 2p
                _mm512_storeu_si512(lo + j, _mm512_add_epi64(X, T));
                _mm512_storeu_si512(
                    hi + j, _mm512_add_epi64(_mm512_sub_epi64(X, T), v2p));
            }
        }
    }
    for (; m < n; m <<= 1, t >>= 1) {       // t = 4, 2, 1
        const unsigned lt = (t == 4) ? 2 : (t == 2) ? 1 : 0;
        const u64* lw = tb.lane_w[lt].data();
        const u64* lws = tb.lane_ws52[lt].data();
        const __mmask8 himask = (t == 4) ? 0xF0 : (t == 2) ? 0xCC : 0xAA;
        const bool last = (t == 1);
        for (u64 i = 0; i < n; i += 8) {
            __m512i x = _mm512_loadu_si512(a + i);
            __m512i y = swap_t(x, t);
            // l: the lo element of each pair in every lane; h: the hi one.
            __m512i l = _mm512_mask_blend_epi64(himask, x, y);
            __m512i h = _mm512_mask_blend_epi64(himask, y, x);
            __mmask8 ge = _mm512_cmpge_epu64_mask(l, v2p);
            l = _mm512_mask_sub_epi64(l, ge, l, v2p);
            __m512i T = shoup52v(h, _mm512_loadu_si512(lw + i),
                                 _mm512_loadu_si512(lws + i), vp, mask52);
            __m512i out_lo = _mm512_add_epi64(l, T);
            __m512i out_hi = _mm512_add_epi64(_mm512_sub_epi64(l, T), v2p);
            __m512i o = _mm512_mask_blend_epi64(himask, out_lo, out_hi);
            if (last) {       // canonicalize [0, 4p) -> [0, p) in-stage
                ge = _mm512_cmpge_epu64_mask(o, v2p);
                o = _mm512_mask_sub_epi64(o, ge, o, v2p);
                ge = _mm512_cmpge_epu64_mask(o, vp);
                o = _mm512_mask_sub_epi64(o, ge, o, vp);
            }
            _mm512_storeu_si512(a + i, o);
        }
    }
}

HE_AVX512_FN static void intt_avx512(const Table& tb, u64* a) {
    const u64 p = tb.p, n = tb.n;
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i v2p = _mm512_set1_epi64((long long)(2 * p));
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    u64 m = n >> 1, t = 1;
    for (; t < 8 && m >= 1; m >>= 1, t <<= 1) {  // t = 1, 2, 4
        const unsigned lt = (t == 4) ? 2 : (t == 2) ? 1 : 0;
        const u64* lw = tb.lane_iw[lt].data();
        const u64* lws = tb.lane_iws52[lt].data();
        const __mmask8 himask = (t == 4) ? 0xF0 : (t == 2) ? 0xCC : 0xAA;
        for (u64 i = 0; i < n; i += 8) {
            __m512i x = _mm512_loadu_si512(a + i);
            __m512i y = swap_t(x, t);
            __m512i l = _mm512_mask_blend_epi64(himask, x, y);  // < 2p
            __m512i h = _mm512_mask_blend_epi64(himask, y, x);  // < 2p
            __m512i S = _mm512_add_epi64(l, h);                 // < 4p
            __mmask8 ge = _mm512_cmpge_epu64_mask(S, v2p);
            S = _mm512_mask_sub_epi64(S, ge, S, v2p);           // < 2p
            __m512i D = _mm512_add_epi64(_mm512_sub_epi64(l, h), v2p);  // < 4p
            __m512i T = shoup52v(D, _mm512_loadu_si512(lw + i),
                                 _mm512_loadu_si512(lws + i), vp, mask52);
            _mm512_storeu_si512(a + i,
                                _mm512_mask_blend_epi64(himask, S, T));
        }
    }
    for (; m >= 1; m >>= 1, t <<= 1) {           // t >= 8
        for (u64 blk = 0; blk < m; ++blk) {
            const __m512i wv = _mm512_set1_epi64((long long)tb.iw[m + blk]);
            const __m512i wsv =
                _mm512_set1_epi64((long long)tb.iws52[m + blk]);
            u64* lo = a + blk * 2 * t;
            u64* hi = lo + t;
            for (u64 j = 0; j < t; j += 8) {
                __m512i X = _mm512_loadu_si512(lo + j);
                __m512i Y = _mm512_loadu_si512(hi + j);
                __m512i S = _mm512_add_epi64(X, Y);
                __mmask8 ge = _mm512_cmpge_epu64_mask(S, v2p);
                S = _mm512_mask_sub_epi64(S, ge, S, v2p);
                __m512i D = _mm512_add_epi64(_mm512_sub_epi64(X, Y), v2p);
                __m512i T = shoup52v(D, wv, wsv, vp, mask52);
                _mm512_storeu_si512(lo + j, S);
                _mm512_storeu_si512(hi + j, T);
            }
        }
    }
    const __m512i ninv = _mm512_set1_epi64((long long)tb.n_inv);
    const __m512i ninvs = _mm512_set1_epi64((long long)tb.n_inv_s52);
    for (u64 i = 0; i < n; i += 8) {
        __m512i x = _mm512_loadu_si512(a + i);              // < 2p
        x = shoup52v(x, ninv, ninvs, vp, mask52);           // < 2p
        __mmask8 ge = _mm512_cmpge_epu64_mask(x, vp);
        x = _mm512_mask_sub_epi64(x, ge, x, vp);            // canonical
        _mm512_storeu_si512(a + i, x);
    }
}

static bool cpu_has_ifma() {
    static const bool ok = __builtin_cpu_supports("avx512ifma") &&
                           __builtin_cpu_supports("avx512dq") &&
                           __builtin_cpu_supports("avx512vl");
    return ok;
}

// ---------------------------------------------------------------------------
// AVX-512 IFMA elementwise helpers for the BEHZ tail.  All accept inputs up
// to 2^52 (not just < p), which subsumes the scalar path's reduce64
// pre-reductions; every helper's output is exactly congruent mod p to the
// scalar computation, and canonical where stated.
// ---------------------------------------------------------------------------

// dst[j] = src[j] * w mod p (canonical).  src < 2^52, w < p.
HE_AVX512_FN static void vec_mulc_avx512(u64* dst, const u64* src, u64 n,
                                         u64 w, u64 p) {
    const u64 ws = shoup52_precompute(w, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i wv = _mm512_set1_epi64((long long)w);
    const __m512i wsv = _mm512_set1_epi64((long long)ws);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i x = _mm512_loadu_si512(src + j);
        __m512i t = shoup52v(x, wv, wsv, vp, mask52);     // < 2p
        __mmask8 ge = _mm512_cmpge_epu64_mask(t, vp);
        t = _mm512_mask_sub_epi64(t, ge, t, vp);
        _mm512_storeu_si512(dst + j, t);
    }
}

// acc[j] += (src[j] * w mod-ish p), the mod-ish term in [0, 2p).
// Caller guarantees the running accumulator stays < 2^52.
HE_AVX512_FN static void vec_addmulc_avx512(u64* acc, const u64* src, u64 n,
                                            u64 w, u64 p) {
    const u64 ws = shoup52_precompute(w, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i wv = _mm512_set1_epi64((long long)w);
    const __m512i wsv = _mm512_set1_epi64((long long)ws);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i x = _mm512_loadu_si512(src + j);
        __m512i t = shoup52v(x, wv, wsv, vp, mask52);
        _mm512_storeu_si512(acc + j,
                            _mm512_add_epi64(_mm512_loadu_si512(acc + j), t));
    }
}

// a[j] (< 2^52) -> a[j] mod p, canonical.  Shoup with w = 1.
HE_AVX512_FN static void vec_reduce_avx512(u64* a, u64 n, u64 p) {
    const u64 mu = shoup52_precompute(1, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i one = _mm512_set1_epi64(1);
    const __m512i muv = _mm512_set1_epi64((long long)mu);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i x = _mm512_loadu_si512(a + j);
        __m512i t = shoup52v(x, one, muv, vp, mask52);    // < 2p
        __mmask8 ge = _mm512_cmpge_epu64_mask(t, vp);
        t = _mm512_mask_sub_epi64(t, ge, t, vp);
        _mm512_storeu_si512(a + j, t);
    }
}

// Montgomery multiply with beta = 2^52: returns x*y*2^-52 mod-ish p in
// [0, 2p), exact for x*y < p * 2^52 (x, y < 2p always qualifies: 4p^2 <
// 2^76 < p * 2^52 since p > 2^24 for any NTT-friendly modulus here).
// pinv52 = -p^-1 mod 2^52.
HE_AVX512_FN static inline __m512i montmul52v(__m512i x, __m512i y,
                                              __m512i p, __m512i pinv52,
                                              __m512i mask52) {
    const __m512i z = _mm512_setzero_si512();
    __m512i lo = _mm512_madd52lo_epu64(z, x, y);
    __m512i hi = _mm512_madd52hi_epu64(z, x, y);
    __m512i q = _mm512_and_si512(_mm512_madd52lo_epu64(z, lo, pinv52),
                                 mask52);
    // (lo + lo52(q*p)) is 0 or 2^52 exactly; carry = (lo != 0).
    __mmask8 carry = _mm512_cmpneq_epu64_mask(lo, z);
    __m512i r = _mm512_madd52hi_epu64(hi, q, p);
    return _mm512_mask_add_epi64(r, carry, r, _mm512_set1_epi64(1));
}

// -p^-1 mod 2^52 (p odd), via Newton iteration on 64 bits then masking.
static u64 pinv52_of(u64 p) {
    u64 inv = p;                      // p^-1 mod 2^3
    for (int i = 0; i < 5; ++i) inv *= 2 - p * inv;   // -> mod 2^64
    return (0 - inv) & ((1ull << 52) - 1);
}

// dst[j] = src[j] * w mod-ish p, in [0, 2p) (no canonicalization).
HE_AVX512_FN static void vec_mulc_lazy_avx512(u64* dst, const u64* src,
                                              u64 n, u64 w, u64 p) {
    const u64 ws = shoup52_precompute(w, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i wv = _mm512_set1_epi64((long long)w);
    const __m512i wsv = _mm512_set1_epi64((long long)ws);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8)
        _mm512_storeu_si512(
            dst + j, shoup52v(_mm512_loadu_si512(src + j), wv, wsv, vp,
                              mask52));
}

// dst[j] = (a[j] - b[j]) * w mod p (canonical).  a, b < p, w < p.
HE_AVX512_FN static void vec_submulc_avx512(u64* dst, const u64* a,
                                            const u64* b, u64 n, u64 w,
                                            u64 p) {
    const u64 ws = shoup52_precompute(w, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i wv = _mm512_set1_epi64((long long)w);
    const __m512i wsv = _mm512_set1_epi64((long long)ws);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i d = _mm512_add_epi64(
            _mm512_sub_epi64(_mm512_loadu_si512(a + j),
                             _mm512_loadu_si512(b + j)), vp);   // < 2p
        __m512i t = shoup52v(d, wv, wsv, vp, mask52);           // < 2p
        __mmask8 ge = _mm512_cmpge_epu64_mask(t, vp);
        t = _mm512_mask_sub_epi64(t, ge, t, vp);
        _mm512_storeu_si512(dst + j, t);
    }
}

// acc[j] += x[j] * y[j] * 2^-52 mod-ish p (Montgomery term < 2p); callers
// pre-lift one operand by 2^52 mod p so the 2^-52 cancels.
HE_AVX512_FN static void vec_addmont_avx512(u64* acc, const u64* x,
                                            const u64* y, u64 n, u64 p) {
    const u64 pinv = pinv52_of(p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i piv = _mm512_set1_epi64((long long)pinv);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i t = montmul52v(_mm512_loadu_si512(x + j),
                               _mm512_loadu_si512(y + j), vp, piv, mask52);
        _mm512_storeu_si512(acc + j,
                            _mm512_add_epi64(_mm512_loadu_si512(acc + j), t));
    }
}

// out[j] = centered((src[j] * w) mod m): representative in [-m/2, m/2)
// shifted so that v > m/2 maps to v - m (golden's strict > comparison).
// 52-bit Shoup with w < m; src < 2^52.
HE_AVX512_FN static void vec_mulc_center_avx512(i64* out, const u64* src,
                                                u64 n, u64 w, u64 m) {
    const u64 ws = shoup52_precompute(w, m);
    const __m512i vm = _mm512_set1_epi64((long long)m);
    const __m512i half = _mm512_set1_epi64((long long)(m / 2));
    const __m512i wv = _mm512_set1_epi64((long long)w);
    const __m512i wsv = _mm512_set1_epi64((long long)ws);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i r = shoup52v(_mm512_loadu_si512(src + j), wv, wsv, vm,
                             mask52);                           // < 2m
        __mmask8 ge = _mm512_cmpge_epu64_mask(r, vm);
        r = _mm512_mask_sub_epi64(r, ge, r, vm);                // canonical
        __mmask8 gt = _mm512_cmpgt_epi64_mask(r, half);
        _mm512_storeu_si512(out + j, _mm512_mask_sub_epi64(r, gt, r, vm));
    }
}

// out[j] = centered(((a[j] - b[j]) * w) mod m), a, b < m canonical.
HE_AVX512_FN static void vec_submulc_center_avx512(i64* out, const u64* a,
                                                   const u64* b, u64 n,
                                                   u64 w, u64 m) {
    const u64 ws = shoup52_precompute(w, m);
    const __m512i vm = _mm512_set1_epi64((long long)m);
    const __m512i half = _mm512_set1_epi64((long long)(m / 2));
    const __m512i wv = _mm512_set1_epi64((long long)w);
    const __m512i wsv = _mm512_set1_epi64((long long)ws);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i d = _mm512_add_epi64(
            _mm512_sub_epi64(_mm512_loadu_si512(a + j),
                             _mm512_loadu_si512(b + j)), vm);   // < 2m
        __m512i r = shoup52v(d, wv, wsv, vm, mask52);           // < 2m
        __mmask8 ge = _mm512_cmpge_epu64_mask(r, vm);
        r = _mm512_mask_sub_epi64(r, ge, r, vm);
        __mmask8 gt = _mm512_cmpgt_epi64_mask(r, half);
        _mm512_storeu_si512(out + j, _mm512_mask_sub_epi64(r, gt, r, vm));
    }
}

// to_bsk final per-base step: o = ((cv + qmx * (r_c mod x)) * imt) mod x,
// with r_c signed and |r_c| <= m_tilde/2 < x.
HE_AVX512_FN static void vec_tobsk_final_avx512(u64* o, const u64* cv,
                                                const i64* r_c, u64 n, u64 x,
                                                u64 qmx, u64 imt) {
    const u64 qs = shoup52_precompute(qmx, x);
    const u64 is = shoup52_precompute(imt, x);
    const __m512i vx = _mm512_set1_epi64((long long)x);
    const __m512i qv = _mm512_set1_epi64((long long)qmx);
    const __m512i qsv = _mm512_set1_epi64((long long)qs);
    const __m512i iv = _mm512_set1_epi64((long long)imt);
    const __m512i isv = _mm512_set1_epi64((long long)is);
    const __m512i z = _mm512_setzero_si512();
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i r = _mm512_loadu_si512(r_c + j);
        __mmask8 neg = _mm512_cmpgt_epi64_mask(z, r);
        r = _mm512_mask_add_epi64(r, neg, r, vx);               // r mod x
        __m512i t = shoup52v(r, qv, qsv, vx, mask52);           // < 2x
        __m512i num = _mm512_add_epi64(_mm512_loadu_si512(cv + j), t);
        t = shoup52v(num, iv, isv, vx, mask52);                 // < 2x
        __mmask8 ge = _mm512_cmpge_epu64_mask(t, vx);
        t = _mm512_mask_sub_epi64(t, ge, t, vx);
        _mm512_storeu_si512(o + j, t);
    }
}

// fastbconv_sk final correction: o = (o - (alpha mod p) * pbq) mod p, with
// alpha signed and |alpha| <= m_sk/2 < p, o < p canonical.
HE_AVX512_FN static void vec_subcorr_avx512(u64* o, const i64* alpha, u64 n,
                                            u64 p, u64 pbq) {
    const u64 ps = shoup52_precompute(pbq, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i v2p = _mm512_set1_epi64((long long)(2 * p));
    const __m512i wv = _mm512_set1_epi64((long long)pbq);
    const __m512i wsv = _mm512_set1_epi64((long long)ps);
    const __m512i z = _mm512_setzero_si512();
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i r = _mm512_loadu_si512(alpha + j);
        __mmask8 neg = _mm512_cmpgt_epi64_mask(z, r);
        r = _mm512_mask_add_epi64(r, neg, r, vp);
        __m512i corr = shoup52v(r, wv, wsv, vp, mask52);        // < 2p
        __m512i t = _mm512_sub_epi64(
            _mm512_add_epi64(_mm512_loadu_si512(o + j), v2p), corr);  // < 3p
        __mmask8 ge = _mm512_cmpge_epu64_mask(t, v2p);
        t = _mm512_mask_sub_epi64(t, ge, t, v2p);
        ge = _mm512_cmpge_epu64_mask(t, vp);
        t = _mm512_mask_sub_epi64(t, ge, t, vp);
        _mm512_storeu_si512(o + j, t);
    }
}

// dst[j] = src[j] mod p for signed src with |src| < p.
HE_AVX512_FN static void vec_signed_mod_avx512(u64* dst, const i64* src,
                                               u64 n, u64 p) {
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i z = _mm512_setzero_si512();
    for (u64 j = 0; j < n; j += 8) {
        __m512i x = _mm512_loadu_si512(src + j);
        __mmask8 neg = _mm512_cmpgt_epi64_mask(z, x);
        _mm512_storeu_si512(dst + j, _mm512_mask_add_epi64(x, neg, x, vp));
    }
}

// o[j] = (base[j] + (e[j] mod p) [+ d[j]]) mod p, canonical; |e| < p,
// base/d canonical.
HE_AVX512_FN static void vec_encrypt_final_avx512(u64* o, const u64* base,
                                                  const i64* e, const u64* d,
                                                  u64 n, u64 p) {
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i z = _mm512_setzero_si512();
    for (u64 j = 0; j < n; j += 8) {
        __m512i ev = _mm512_loadu_si512(e + j);
        __mmask8 neg = _mm512_cmpgt_epi64_mask(z, ev);
        ev = _mm512_mask_add_epi64(ev, neg, ev, vp);
        __m512i x = _mm512_add_epi64(_mm512_loadu_si512(base + j), ev);
        __mmask8 ge = _mm512_cmpge_epu64_mask(x, vp);
        x = _mm512_mask_sub_epi64(x, ge, x, vp);
        if (d) {
            x = _mm512_add_epi64(x, _mm512_loadu_si512(d + j));
            ge = _mm512_cmpge_epu64_mask(x, vp);
            x = _mm512_mask_sub_epi64(x, ge, x, vp);
        }
        _mm512_storeu_si512(o + j, x);
    }
}

// Relinearization P-division epilogue for one (component, limb):
//   o = ct + ((a - (((xP + half) mod P) mod p - halfp)) * invP) mod p
// with all inputs canonical; exactly golden.relinearize's final loop.
HE_AVX512_FN static void vec_relin_pdiv_avx512(u64* o, const u64* cti,
                                               const u64* ai, const u64* xP,
                                               u64 n, u64 p, u64 P, u64 half,
                                               u64 halfp, u64 ipq) {
    const u64 mu = shoup52_precompute(1, p);
    const u64 is = shoup52_precompute(ipq, p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i vP = _mm512_set1_epi64((long long)P);
    const __m512i vhalf = _mm512_set1_epi64((long long)half);
    const __m512i vhalfp = _mm512_set1_epi64((long long)halfp);
    const __m512i one = _mm512_set1_epi64(1);
    const __m512i muv = _mm512_set1_epi64((long long)mu);
    const __m512i iv = _mm512_set1_epi64((long long)ipq);
    const __m512i isv = _mm512_set1_epi64((long long)is);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i xph = _mm512_add_epi64(_mm512_loadu_si512(xP + j), vhalf);
        __mmask8 ge = _mm512_cmpge_epu64_mask(xph, vP);
        xph = _mm512_mask_sub_epi64(xph, ge, xph, vP);      // mod P < 2^52
        __m512i r = shoup52v(xph, one, muv, vp, mask52);    // < 2p
        ge = _mm512_cmpge_epu64_mask(r, vp);
        r = _mm512_mask_sub_epi64(r, ge, r, vp);            // xph mod p
        // corr = r - halfp mod p; ti = ai - corr mod p
        __m512i corr = _mm512_add_epi64(_mm512_sub_epi64(r, vhalfp), vp);
        ge = _mm512_cmpge_epu64_mask(corr, vp);
        corr = _mm512_mask_sub_epi64(corr, ge, corr, vp);
        __m512i ti = _mm512_add_epi64(
            _mm512_sub_epi64(_mm512_loadu_si512(ai + j), corr), vp);
        ge = _mm512_cmpge_epu64_mask(ti, vp);
        ti = _mm512_mask_sub_epi64(ti, ge, ti, vp);
        __m512i m = shoup52v(ti, iv, isv, vp, mask52);      // < 2p
        ge = _mm512_cmpge_epu64_mask(m, vp);
        m = _mm512_mask_sub_epi64(m, ge, m, vp);
        __m512i res = _mm512_add_epi64(_mm512_loadu_si512(cti + j), m);
        ge = _mm512_cmpge_epu64_mask(res, vp);
        _mm512_storeu_si512(o + j, _mm512_mask_sub_epi64(res, ge, res, vp));
    }
}

// Plaintext Delta-scaling for one limb:
//   o = (d * (m mod p) + ((q_mod_t * m + t/2) / t) mod p) mod p
// The exact floor division by t uses mu = floor(2^52/t) with a one-step
// correction (x < 2^52, so the estimate is off by at most 1).
HE_AVX512_FN static void vec_scale_plain_avx512(u64* o, const u64* m, u64 n,
                                                u64 p, u64 d, u64 q_mod_t,
                                                u64 t) {
    const u64 ds = shoup52_precompute(d, p);
    const u64 mu_p = shoup52_precompute(1, p);
    const u64 mu_t = (u64)((((u128)1) << 52) / t);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i vt = _mm512_set1_epi64((long long)t);
    const __m512i vt2 = _mm512_set1_epi64((long long)(t / 2));
    const __m512i vq = _mm512_set1_epi64((long long)q_mod_t);
    const __m512i dv = _mm512_set1_epi64((long long)d);
    const __m512i dsv = _mm512_set1_epi64((long long)ds);
    const __m512i one = _mm512_set1_epi64(1);
    const __m512i mupv = _mm512_set1_epi64((long long)mu_p);
    const __m512i mutv = _mm512_set1_epi64((long long)mu_t);
    const __m512i z = _mm512_setzero_si512();
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i mv = _mm512_loadu_si512(m + j);             // < t <= 2^37
        // x = q_mod_t * m + t/2 (exact: < t^2 + t/2 < 2^52 via lo52)
        __m512i x = _mm512_madd52lo_epu64(vt2, vq, mv);
        // fix = floor(x / t): estimate then correct once
        __m512i qest = _mm512_madd52hi_epu64(z, x, mutv);
        __m512i rem = _mm512_sub_epi64(
            x, _mm512_madd52lo_epu64(z, qest, vt));
        rem = _mm512_and_si512(rem, mask52);
        __mmask8 ge = _mm512_cmpge_epu64_mask(rem, vt);
        __m512i fix = _mm512_mask_add_epi64(qest, ge, qest, one);
        // fix < t; fix mod p (fix may exceed p only if t > p: reduce52)
        __m512i fr = shoup52v(fix, one, mupv, vp, mask52);
        ge = _mm512_cmpge_epu64_mask(fr, vp);
        fr = _mm512_mask_sub_epi64(fr, ge, fr, vp);
        // mr = m mod p
        __m512i mr = shoup52v(mv, one, mupv, vp, mask52);
        ge = _mm512_cmpge_epu64_mask(mr, vp);
        mr = _mm512_mask_sub_epi64(mr, ge, mr, vp);
        // o = d * mr + fr mod p
        __m512i dm = shoup52v(mr, dv, dsv, vp, mask52);
        ge = _mm512_cmpge_epu64_mask(dm, vp);
        dm = _mm512_mask_sub_epi64(dm, ge, dm, vp);
        __m512i res = _mm512_add_epi64(dm, fr);
        ge = _mm512_cmpge_epu64_mask(res, vp);
        _mm512_storeu_si512(o + j, _mm512_mask_sub_epi64(res, ge, res, vp));
    }
}

// Dyadic stage of BEHZ multiply for one base: given NTT-form a0,a1,b0,b1
// (canonical), produce p0 = a0*b0, p1 = a0*b1 + a1*b0, p2 = a1*b1, each in
// [0, 2p) -- lazily congruent, canonicalized downstream by intt_avx512.
HE_AVX512_FN static void vec_dyadic_avx512(const u64* a0, const u64* a1,
                                           const u64* b0, const u64* b1,
                                           u64 n, u64 p,
                                           u64* p0, u64* p1, u64* p2) {
    const u64 r52 = (u64)((((u128)1) << 52) % p);     // 2^52 mod p
    const u64 r52s = shoup52_precompute(r52, p);
    const u64 pinv = pinv52_of(p);
    const __m512i vp = _mm512_set1_epi64((long long)p);
    const __m512i v2p = _mm512_set1_epi64((long long)(2 * p));
    const __m512i rv = _mm512_set1_epi64((long long)r52);
    const __m512i rsv = _mm512_set1_epi64((long long)r52s);
    const __m512i piv = _mm512_set1_epi64((long long)pinv);
    const __m512i mask52 = _mm512_set1_epi64((long long)((1ull << 52) - 1));
    for (u64 j = 0; j < n; j += 8) {
        __m512i x0 = _mm512_loadu_si512(a0 + j);
        __m512i x1 = _mm512_loadu_si512(a1 + j);
        __m512i y0 = _mm512_loadu_si512(b0 + j);
        __m512i y1 = _mm512_loadu_si512(b1 + j);
        // lift a-side into the Montgomery domain: x*2^52 mod-ish p (< 2p)
        __m512i x0m = shoup52v(x0, rv, rsv, vp, mask52);
        __m512i x1m = shoup52v(x1, rv, rsv, vp, mask52);
        __m512i q0 = montmul52v(x0m, y0, vp, piv, mask52);          // < 2p
        __m512i q2 = montmul52v(x1m, y1, vp, piv, mask52);          // < 2p
        __m512i q1 = _mm512_add_epi64(montmul52v(x0m, y1, vp, piv, mask52),
                                      montmul52v(x1m, y0, vp, piv, mask52));
        __mmask8 ge = _mm512_cmpge_epu64_mask(q1, v2p);
        q1 = _mm512_mask_sub_epi64(q1, ge, q1, v2p);                // < 2p
        _mm512_storeu_si512(p0 + j, q0);
        _mm512_storeu_si512(p1 + j, q1);
        _mm512_storeu_si512(p2 + j, q2);
    }
}
#endif  // HE_HAVE_AVX512

// Forward negacyclic NTT, natural -> bit-reversed (golden bfv/ntt.py ntt()).
static void ntt_inplace(const Table& tb, u64* a) {
#ifdef HE_HAVE_AVX512
    if (tb.n >= 8 && cpu_has_ifma()) { ntt_avx512(tb, a); return; }
#endif
    const u64 p = tb.p, n = tb.n;
    u64 t = n;
    for (u64 m = 1; m < n; m <<= 1) {
        t >>= 1;
        for (u64 blk = 0; blk < m; ++blk) {
            const u64 wv = tb.w[m + blk], wsv = tb.ws[m + blk];
            u64* lo = a + blk * 2 * t;
            u64* hi = lo + t;
            for (u64 j = 0; j < t; ++j) {
                u64 x = lo[j];
                u64 y = shoup_mul(hi[j], wv, wsv, p);
                lo[j] = addmod(x, y, p);
                hi[j] = submod(x, y, p);
            }
        }
    }
}

// Inverse negacyclic NTT, bit-reversed -> natural (golden bfv/ntt.py intt()).
static void intt_inplace(const Table& tb, u64* a) {
#ifdef HE_HAVE_AVX512
    if (tb.n >= 8 && cpu_has_ifma()) { intt_avx512(tb, a); return; }
#endif
    const u64 p = tb.p, n = tb.n;
    u64 t = 1;
    for (u64 m = n >> 1; m >= 1; m >>= 1) {
        for (u64 blk = 0; blk < m; ++blk) {
            const u64 wv = tb.iw[m + blk], wsv = tb.iws[m + blk];
            u64* lo = a + blk * 2 * t;
            u64* hi = lo + t;
            for (u64 j = 0; j < t; ++j) {
                u64 x = lo[j], y = hi[j];
                lo[j] = addmod(x, y, p);
                hi[j] = shoup_mul(submod(x, y, p), wv, wsv, p);
            }
        }
        t <<= 1;
    }
    for (u64 j = 0; j < n; ++j)
        a[j] = shoup_mul(a[j], tb.n_inv, tb.n_inv_s, p);
}

// ---------------------------------------------------------------------------
// Context: params + every derived constant (mirrors BfvContext.__init__)
// ---------------------------------------------------------------------------

struct Ctx {
    u64 n = 0, t = 0;
    std::vector<u64> qm;        // ct moduli (k)
    std::vector<u64> keym;      // key moduli (k_key)
    std::vector<u64> B;         // aux base
    std::vector<u64> bsk;       // B + [m_sk]
    u64 m_sk = 0, m_tilde = 0;
    size_t k = 0, k_key = 0, nB = 0;
    std::map<u64, Table> tables;
    std::map<u64, Barrett> brs;     // Barrett for every modulus incl. m_tilde

    // Δ-scaling
    std::vector<u64> delta_mod_q;
    u64 q_mod_t = 0;

    // CRT compose (decrypt)
    u128 q = 0;
    std::vector<u128> q_hat;
    std::vector<u64> q_hat_inv;

    // keyswitch
    bool has_special = false;
    u64 P = 0, P_half = 0;
    std::vector<u64> inv_P_mod_q, half_mod_q;

    // BEHZ
    std::map<u64, std::vector<u64>> q_hat_mod_x;  // x in bsk + {m_tilde}
    std::map<u64, u64> q_mod_x;                   // x in bsk
    std::vector<u64> mtilde_mod_q;
    u64 neg_inv_q_mod_mtilde = 0;
    std::map<u64, u64> inv_mtilde_mod_x, inv_q_mod_x;   // x in bsk
    std::vector<u64> b_hat_inv;
    std::map<u64, std::vector<u64>> b_hat_mod_x;  // x in qm + {m_sk}
    std::vector<u64> prod_B_mod_q;
    u64 inv_prod_B_mod_msk = 0;

    const Table& tab(u64 p) const { return tables.at(p); }
    const Barrett& bar(u64 p) const { return brs.at(p); }
};

static u64 prod_mod(const std::vector<u64>& ms, u64 x, size_t skip = SIZE_MAX) {
    u128 acc = 1 % x;
    for (size_t i = 0; i < ms.size(); ++i) {
        if (i == skip) continue;
        acc = acc * (ms[i] % x) % x;
    }
    return (u64)acc;
}

}  // namespace

extern "C" {

// Returns NULL if parameters are unsupported (caller falls back to golden).
void* he_ctx_new(u64 n, u64 t,
                 const u64* q_mods, u64 k,
                 const u64* key_mods, u64 k_key,
                 const u64* aux, u64 n_aux,
                 u64 m_sk, u64 m_tilde) {
    if (k == 0 || k > 4 || n < 8 || (n & (n - 1)) || t < 2) return nullptr;
    Ctx* c = new Ctx();
    c->n = n; c->t = t;
    c->qm.assign(q_mods, q_mods + k);
    c->keym.assign(key_mods, key_mods + k_key);
    c->B.assign(aux, aux + n_aux);
    c->m_sk = m_sk; c->m_tilde = m_tilde;
    c->bsk = c->B; c->bsk.push_back(m_sk);
    c->k = k; c->k_key = k_key; c->nB = n_aux;

    // q and CRT hats must fit u128 with headroom (q < 2^122, k*q < 2^125)
    u128 q = 1;
    for (u64 i = 0; i < k; ++i) {
        if (q_mods[i] >= (1ULL << 37)) { delete c; return nullptr; }
        if (q > (((u128)1) << 122) / q_mods[i]) { delete c; return nullptr; }
        q *= q_mods[i];
    }
    c->q = q;

    // NTT tables for every NTT-bearing modulus
    std::vector<u64> all_p(c->keym);
    for (u64 b : c->bsk) all_p.push_back(b);
    for (u64 p : all_p) {
        if (p >= (1ULL << 37)) { delete c; return nullptr; }
        if (!c->tables.count(p)) {
            Table tb;
            if (!tb.init(p, n)) { delete c; return nullptr; }
            c->tables.emplace(p, std::move(tb));
        }
        if (!c->brs.count(p)) { Barrett b; b.init(p); c->brs.emplace(p, b); }
    }
    { Barrett b; b.init(m_tilde); c->brs.emplace(m_tilde, b); }

    // Δ constants (golden.py:103-108)
    u128 delta = q / t;
    for (u64 i = 0; i < k; ++i)
        c->delta_mod_q.push_back((u64)(delta % q_mods[i]));
    c->q_mod_t = (u64)(q % t);

    // CRT compose (golden.py:111-113)
    for (u64 i = 0; i < k; ++i) {
        u128 hat = 1;
        for (u64 j = 0; j < k; ++j) if (j != i) hat *= q_mods[j];
        c->q_hat.push_back(hat);
        c->q_hat_inv.push_back(invmod((u64)(hat % q_mods[i]), q_mods[i]));
    }

    // keyswitch constants (golden.py:116-121)
    if (k_key > k) {
        c->has_special = true;
        c->P = key_mods[k_key - 1];
        c->P_half = c->P >> 1;
        for (u64 i = 0; i < k; ++i) {
            c->inv_P_mod_q.push_back(invmod(c->P % q_mods[i], q_mods[i]));
            c->half_mod_q.push_back(c->P_half % q_mods[i]);
        }
    }

    // BEHZ constants (golden.py:123-151)
    u64 mt = m_tilde;
    std::vector<u64> targets = c->bsk; targets.push_back(mt);
    for (u64 x : targets) {
        std::vector<u64> hats(k);
        for (u64 i = 0; i < k; ++i) hats[i] = (u64)(c->q_hat[i] % x);
        c->q_hat_mod_x[x] = hats;
    }
    for (u64 x : c->bsk) {
        c->q_mod_x[x] = (u64)(q % x);
        c->inv_mtilde_mod_x[x] = invmod(mt % x, x);
        c->inv_q_mod_x[x] = invmod((u64)(q % x), x);
    }
    for (u64 i = 0; i < k; ++i) c->mtilde_mod_q.push_back(mt % q_mods[i]);
    c->neg_inv_q_mod_mtilde = (mt - invmod((u64)(q % mt), mt)) % mt;

    for (size_t i = 0; i < c->nB; ++i)
        c->b_hat_inv.push_back(
            invmod(prod_mod(c->B, c->B[i], i), c->B[i]));
    std::vector<u64> bx(c->qm); bx.push_back(m_sk);
    for (u64 x : bx) {
        std::vector<u64> hats(c->nB);
        for (size_t i = 0; i < c->nB; ++i) hats[i] = prod_mod(c->B, x, i);
        c->b_hat_mod_x[x] = hats;
    }
    for (u64 i = 0; i < k; ++i)
        c->prod_B_mod_q.push_back(prod_mod(c->B, q_mods[i]));
    c->inv_prod_B_mod_msk = invmod(prod_mod(c->B, m_sk), m_sk);
    return c;
}

void he_ctx_free(void* h) { delete (Ctx*)h; }

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// internal op helpers (array layouts match golden.py numpy arrays)
// ---------------------------------------------------------------------------

// Per-thread reusable scratch: fresh std::vector allocations cost more than
// the NTTs themselves at n=4096 (zero-fill + mmap page churn, measured
// ~0.5 ms per multiply).  Each call site owns a distinct slot; two sites
// share a slot only if they can never be live in the same call tree.
//   0-5   he_multiply: ea, eb, prod, tq, conv, floor_bsk
//   6-7   to_bsk: scaled, conv
//   8     fastbconv_q: ys
//   9-11  fastbconv_sk: ys, acc, alpha(i64)
//   12    to_bsk: r_c(i64)
//   13-14 he_relinearize: acc, dji
//   15-18 he_decrypt: dot, acc, term, cur | he_encrypt: dm, u_ntt, c0, c1
static u64* scratch(unsigned slot, size_t count) {
    thread_local std::vector<u64> pool[20];
    auto& v = pool[slot];
    if (v.size() < count) v.resize(count);
    return v.data();
}

// round(q*m/t) mod each q_j: (n,) mod-t -> (k, n)   (golden._scale_plain)
static void scale_plain(const Ctx& c, const u64* m, u64* out) {
    const u64 n = c.n, t = c.t, t2 = t / 2;
    for (size_t j = 0; j < c.k; ++j) {
        const u64 p = c.qm[j];
        const u64 d = c.delta_mod_q[j];
        u64* o = out + j * n;
#ifdef HE_HAVE_AVX512
        if (n % 8 == 0 && t < (1ull << 26) && cpu_has_ifma()) {
            vec_scale_plain_avx512(o, m, n, p, d, c.q_mod_t, t);
            continue;
        }
#endif
        const Barrett& br = c.bar(p);
        for (u64 i = 0; i < n; ++i) {
            u64 fix = (c.q_mod_t * m[i] + t2) / t;   // < t (exact identity)
            o[i] = addmod(br.mul(d, m[i] % p), fix % p, p);
        }
    }
}

// FastBconv q -> targets (golden._fastbconv_q).  poly (k, n), out (|tg|, n).
static void fastbconv_q(const Ctx& c, const u64* poly,
                        const std::vector<u64>& targets, u64* out) {
    const u64 n = c.n;
    const size_t k = c.k;
    u64* ys = scratch(8, k * n);
#ifdef HE_HAVE_AVX512
    if (n % 8 == 0 && cpu_has_ifma()) {
        for (size_t i = 0; i < k; ++i)
            vec_mulc_avx512(ys + i * n, poly + i * n, n,
                            c.q_hat_inv[i], c.qm[i]);
        for (size_t xi = 0; xi < targets.size(); ++xi) {
            const u64 x = targets[xi];
            const std::vector<u64>& hats = c.q_hat_mod_x.at(x);
            u64* o = out + xi * n;
            std::memset(o, 0, n * sizeof(u64));
            // 52-bit Shoup accepts any y < 2^52, subsuming the scalar
            // path's cross-base reduce64; k <= 4 lazy terms < 2x each.
            for (size_t i = 0; i < k; ++i)
                vec_addmulc_avx512(o, ys + i * n, n, hats[i], x);
            vec_reduce_avx512(o, n, x);
        }
        return;
    }
#endif
    for (size_t i = 0; i < k; ++i) {
        const Barrett& br = c.bar(c.qm[i]);
        const u64 qi = c.q_hat_inv[i];
        const u64* src = poly + i * n;
        u64* dst = ys + i * n;
        for (u64 j = 0; j < n; ++j) dst[j] = br.mul(src[j], qi);
    }
    for (size_t xi = 0; xi < targets.size(); ++xi) {
        const u64 x = targets[xi];
        const Barrett& br = c.bar(x);
        const std::vector<u64>& hats = c.q_hat_mod_x.at(x);
        u64* o = out + xi * n;
        std::memset(o, 0, n * sizeof(u64));
        for (size_t i = 0; i < k; ++i) {
            const u64 h = hats[i];
            const u64* y = ys + i * n;
            // y values live mod q_i which may exceed x: pre-reduce
            for (u64 j = 0; j < n; ++j)
                o[j] = addmod(o[j], br.mul(br.reduce64(y[j]), h), x);
        }
    }
}

// base-q poly -> Bsk residues via m_tilde Montgomery lift (golden._to_bsk).
static void to_bsk(const Ctx& c, const u64* poly, u64* out) {
    const u64 n = c.n, mt = c.m_tilde;
    const size_t k = c.k, nbsk = c.bsk.size();
    u64* scaled = scratch(6, k * n);
#ifdef HE_HAVE_AVX512
    const bool vec = (n % 8 == 0) && cpu_has_ifma();
#else
    const bool vec = false;
#endif
    for (size_t i = 0; i < k; ++i) {
        const u64 mtq = c.mtilde_mod_q[i];
        const u64* src = poly + i * n;
        u64* dst = scaled + i * n;
#ifdef HE_HAVE_AVX512
        if (vec) { vec_mulc_avx512(dst, src, n, mtq, c.qm[i]); continue; }
#endif
        const Barrett& br = c.bar(c.qm[i]);
        for (u64 j = 0; j < n; ++j) dst[j] = br.mul(src[j], mtq);
    }
    std::vector<u64> targets = c.bsk; targets.push_back(mt);
    u64* conv = scratch(7, (nbsk + 1) * n);
    fastbconv_q(c, scaled, targets, conv);
    const u64* c_mt = conv + nbsk * n;
    i64* r_c = (i64*)scratch(12, n);
#ifdef HE_HAVE_AVX512
    if (vec && mt <= (1ull << 37)) {
        vec_mulc_center_avx512(r_c, c_mt, n, c.neg_inv_q_mod_mtilde, mt);
    } else
#endif
    {
        const Barrett& brmt = c.bar(mt);
        for (u64 j = 0; j < n; ++j) {
            u64 r = brmt.mul(c_mt[j], c.neg_inv_q_mod_mtilde);
            r_c[j] = (i64)r > (i64)(mt / 2) ? (i64)r - (i64)mt : (i64)r;
        }
    }
    for (size_t xi = 0; xi < nbsk; ++xi) {
        const u64 x = c.bsk[xi];
        const u64 qmx = c.q_mod_x.at(x), imt = c.inv_mtilde_mod_x.at(x);
        const u64* cv = conv + xi * n;
        u64* o = out + xi * n;
#ifdef HE_HAVE_AVX512
        if (vec) {
            vec_tobsk_final_avx512(o, cv, r_c, n, x, qmx, imt);
            continue;
        }
#endif
        const Barrett& br = c.bar(x);
        for (u64 j = 0; j < n; ++j) {
            u64 rm = fmod_signed(r_c[j], x);
            u64 num = addmod(cv[j], br.mul(qmx, rm), x);
            o[j] = br.mul(num, imt);
        }
    }
}

// Shenoy-Kumaresan exact Bsk -> q (golden._fastbconv_sk). in (nbsk, n).
static void fastbconv_sk(const Ctx& c, const u64* poly, u64* out) {
    const u64 n = c.n, msk = c.m_sk;
    const size_t nB = c.nB, k = c.k;
#ifdef HE_HAVE_AVX512
    const bool vec = (n % 8 == 0) && cpu_has_ifma();
#else
    const bool vec = false;
#endif
    u64* ys = scratch(9, nB * n);
    for (size_t i = 0; i < nB; ++i) {
        const u64 bi = c.b_hat_inv[i];
        const u64* src = poly + i * n;
        u64* dst = ys + i * n;
#ifdef HE_HAVE_AVX512
        if (vec) { vec_mulc_avx512(dst, src, n, bi, c.B[i]); continue; }
#endif
        const Barrett& br = c.bar(c.B[i]);
        for (u64 j = 0; j < n; ++j) dst[j] = br.mul(src[j], bi);
    }
    // alpha via m_sk
    const Barrett& brm = c.bar(msk);
    const std::vector<u64>& hm = c.b_hat_mod_x.at(msk);
    i64* alpha_c = (i64*)scratch(11, n);
    {
        u64* acc = scratch(10, n);
        std::memset(acc, 0, n * sizeof(u64));
        const u64* pmsk = poly + nB * n;
#ifdef HE_HAVE_AVX512
        if (vec) {
            for (size_t i = 0; i < nB; ++i)
                vec_addmulc_avx512(acc, ys + i * n, n, hm[i], msk);
            vec_reduce_avx512(acc, n, msk);
            vec_submulc_center_avx512(alpha_c, acc, pmsk, n,
                                      c.inv_prod_B_mod_msk, msk);
        } else
#endif
        {
            for (size_t i = 0; i < nB; ++i) {
                const u64 h = hm[i];
                const u64* y = ys + i * n;
                for (u64 j = 0; j < n; ++j)
                    acc[j] = addmod(acc[j],
                                    brm.mul(brm.reduce64(y[j]), h), msk);
            }
            for (u64 j = 0; j < n; ++j) {
                u64 a = brm.mul(submod(acc[j], pmsk[j], msk),
                                c.inv_prod_B_mod_msk);
                alpha_c[j] =
                    (i64)a > (i64)(msk / 2) ? (i64)a - (i64)msk : (i64)a;
            }
        }
    }
    for (size_t qi = 0; qi < k; ++qi) {
        const u64 p = c.qm[qi];
        const std::vector<u64>& hats = c.b_hat_mod_x.at(p);
        const u64 pbq = c.prod_B_mod_q[qi];
        u64* o = out + qi * n;
        std::memset(o, 0, n * sizeof(u64));
#ifdef HE_HAVE_AVX512
        if (vec) {
            for (size_t i = 0; i < nB; ++i)
                vec_addmulc_avx512(o, ys + i * n, n, hats[i], p);
            vec_reduce_avx512(o, n, p);
            vec_subcorr_avx512(o, alpha_c, n, p, pbq);
            continue;
        }
#endif
        const Barrett& br = c.bar(p);
        for (size_t i = 0; i < nB; ++i) {
            const u64 h = hats[i];
            const u64* y = ys + i * n;
            for (u64 j = 0; j < n; ++j)
                o[j] = addmod(o[j], br.mul(br.reduce64(y[j]), h), p);
        }
        for (u64 j = 0; j < n; ++j) {
            u64 corr = br.mul(fmod_signed(alpha_c[j], p), pbq);
            o[j] = submod(o[j], corr, p);
        }
    }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// elementwise ciphertext ops.  ct arrays: (size, k, n) contiguous u64.
// ---------------------------------------------------------------------------

void he_add(void* h, const u64* a, const u64* b, u64 size, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    for (u64 s = 0; s < size; ++s)
        for (size_t j = 0; j < c.k; ++j) {
            const u64 p = c.qm[j];
            const u64* pa = a + (s * c.k + j) * c.n;
            const u64* pb = b + (s * c.k + j) * c.n;
            u64* po = out + (s * c.k + j) * c.n;
            for (u64 i = 0; i < c.n; ++i) po[i] = addmod(pa[i], pb[i], p);
        }
}

void he_sub(void* h, const u64* a, const u64* b, u64 size, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    for (u64 s = 0; s < size; ++s)
        for (size_t j = 0; j < c.k; ++j) {
            const u64 p = c.qm[j];
            const u64* pa = a + (s * c.k + j) * c.n;
            const u64* pb = b + (s * c.k + j) * c.n;
            u64* po = out + (s * c.k + j) * c.n;
            for (u64 i = 0; i < c.n; ++i) po[i] = submod(pa[i], pb[i], p);
        }
}

void he_neg(void* h, const u64* a, u64 size, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    for (u64 s = 0; s < size; ++s)
        for (size_t j = 0; j < c.k; ++j) {
            const u64 p = c.qm[j];
            const u64* pa = a + (s * c.k + j) * c.n;
            u64* po = out + (s * c.k + j) * c.n;
            for (u64 i = 0; i < c.n; ++i) po[i] = negmod(pa[i], p);
        }
}

// out = a with round(q*m/t) added to / subtracted from component 0.
// mode 0: add_plain, 1: sub_plain, 2: plain_sub (= -(a - m)).
void he_plain_affine(void* h, const u64* a, u64 size, const u64* m,
                     int mode, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    std::memcpy(out, a, size * c.k * n * sizeof(u64));
    std::vector<u64> dm(c.k * n);
    scale_plain(c, m, dm.data());
    for (size_t j = 0; j < c.k; ++j) {
        const u64 p = c.qm[j];
        u64* o = out + j * n;
        const u64* d = dm.data() + j * n;
        for (u64 i = 0; i < n; ++i)
            o[i] = mode == 0 ? addmod(o[i], d[i], p) : submod(o[i], d[i], p);
    }
    if (mode == 2)
        he_neg(h, out, size, out);
}

// ct * plain: negacyclic product of every component with the plain poly.
void he_mul_plain(void* h, const u64* a, u64 size, const u64* m, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    std::vector<u64> m_ntt(n), comp(n);
    for (size_t j = 0; j < c.k; ++j) {
        const u64 p = c.qm[j];
        const Table& tb = c.tab(p);
        const Barrett& br = c.bar(p);
        for (u64 i = 0; i < n; ++i) m_ntt[i] = m[i] % p;
        ntt_inplace(tb, m_ntt.data());
        for (u64 s = 0; s < size; ++s) {
            const u64* src = a + (s * c.k + j) * n;
            std::memcpy(comp.data(), src, n * sizeof(u64));
            ntt_inplace(tb, comp.data());
            for (u64 i = 0; i < n; ++i) comp[i] = br.mul(comp[i], m_ntt[i]);
            intt_inplace(tb, comp.data());
            std::memcpy(out + (s * c.k + j) * n, comp.data(), n * sizeof(u64));
        }
    }
}

// ---------------------------------------------------------------------------
// encryption: caller-supplied randomness (golden.encrypt_with_randomness)
// m: (n,) mod t; u/e0/e1: (n,) signed; pk: (2, k_key, n) NTT form.
// out: (2, k, n) coefficient form.
// ---------------------------------------------------------------------------

// Uniform ternary in {-1,0,1} via 2-bit rejection -- byte-identical stream
// consumption to sampling.sample_ternary.
void he_sample_ternary(const uint8_t* seed, u64 domain, u64 n, i64* out) {
    Xof xof(seed, domain);
    u64 filled = 0;
    std::vector<uint8_t> raw;
    while (filled < n) {
        const u64 need = n - filled;
        raw.resize(need + need / 2 + 8);
        xof.read(raw.data(), raw.size());
        for (size_t i = 0; i < raw.size() && filled < n; ++i) {
            const uint8_t v = raw[i] & 3;
            if (v < 3) out[filled++] = (i64)v - 1;
        }
    }
}

namespace {
// One CBD draw: sum of kcbd bits minus sum of kcbd bits, MSB-first bit order
// (np.unpackbits); consumes ceil(2*kcbd*n/8) bytes from the stream.
static void sample_cbd_once(Xof& xof, u64 n, u64 kcbd, i64* out) {
    const u64 nbits = 2 * kcbd * n;
    const u64 nbytes = (nbits + 7) / 8;
    std::vector<uint8_t> raw(nbytes + 8, 0);     // +8: safe 64-bit windows
    xof.read(raw.data(), nbytes);
    if (kcbd <= 21) {
        // popcount on a 42-bit (2*kcbd <= 42 <= 57-bit) window per coeff
        for (u64 j = 0; j < n; ++j) {
            const u64 bit = j * 2 * kcbd;
            u64 w;
            std::memcpy(&w, raw.data() + (bit >> 3), 8);
            w = __builtin_bswap64(w) << (bit & 7);   // MSB-aligned window
            const u64 pos = (u64)__builtin_popcountll(w >> (64 - kcbd));
            const u64 neg = (u64)__builtin_popcountll(
                (w << kcbd) >> (64 - kcbd));
            out[j] = (i64)pos - (i64)neg;
        }
    } else {
        for (u64 j = 0; j < n; ++j) {
            i64 s = 0;
            for (u64 b = 0; b < 2 * kcbd; ++b) {
                const u64 i = j * 2 * kcbd + b;
                const int v = (raw[i >> 3] >> (7 - (i & 7))) & 1;
                s += (b < kcbd) ? v : -v;
            }
            out[j] = s;
        }
    }
}
}  // namespace

// e0 then e1 from ONE error stream (sampling order in NativeEngine.encrypt
// and golden.encrypt: e0 = sample_cbd(xof); e1 = sample_cbd(xof)).
void he_sample_cbd_pair(const uint8_t* seed, u64 domain, u64 n, u64 kcbd,
                        i64* e0, i64* e1) {
    Xof xof(seed, domain);
    sample_cbd_once(xof, n, kcbd, e0);
    sample_cbd_once(xof, n, kcbd, e1);
}

void he_encrypt(void* h, const u64* m, const i64* u, const i64* e0,
                const i64* e1, const u64* pk, u64 k_key_stride, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    u64* dm = scratch(15, c.k * n);
    u64* u_ntt = scratch(16, n);
    u64* c0 = scratch(17, n);
    u64* c1 = scratch(18, n);
    scale_plain(c, m, dm);
#ifdef HE_HAVE_AVX512
    const bool vec = (n % 8 == 0) && cpu_has_ifma();
#else
    const bool vec = false;
#endif
    for (size_t j = 0; j < c.k; ++j) {
        const u64 p = c.qm[j];
        const Table& tb = c.tab(p);
        const u64* pk0 = pk + (0 * k_key_stride + j) * n;
        const u64* pk1 = pk + (1 * k_key_stride + j) * n;
        u64* o0 = out + j * n;
        u64* o1 = out + (c.k + j) * n;
        const u64* d = dm + j * n;
#ifdef HE_HAVE_AVX512
        if (vec) {
            vec_signed_mod_avx512(u_ntt, u, n, p);
            ntt_inplace(tb, u_ntt);
            const u64 r52 = (u64)((((u128)1) << 52) % p);
            vec_mulc_lazy_avx512(u_ntt, u_ntt, n, r52, p);
            std::memset(c0, 0, n * sizeof(u64));
            std::memset(c1, 0, n * sizeof(u64));
            vec_addmont_avx512(c0, u_ntt, pk0, n, p);
            vec_addmont_avx512(c1, u_ntt, pk1, n, p);
            intt_inplace(tb, c0);   // accepts < 2p, emits canonical
            intt_inplace(tb, c1);
            vec_encrypt_final_avx512(o0, c0, e0, d, n, p);
            vec_encrypt_final_avx512(o1, c1, e1, nullptr, n, p);
            continue;
        }
#endif
        const Barrett& br = c.bar(p);
        for (u64 i = 0; i < n; ++i) u_ntt[i] = fmod_signed(u[i], p);
        ntt_inplace(tb, u_ntt);
        for (u64 i = 0; i < n; ++i) {
            c0[i] = br.mul(u_ntt[i], pk0[i]);
            c1[i] = br.mul(u_ntt[i], pk1[i]);
        }
        intt_inplace(tb, c0);
        intt_inplace(tb, c1);
        for (u64 i = 0; i < n; ++i) {
            o0[i] = addmod(addmod(c0[i], fmod_signed(e0[i], p), p), d[i], p);
            o1[i] = addmod(c1[i], fmod_signed(e1[i], p), p);
        }
    }
}

// ---------------------------------------------------------------------------
// decryption (golden._dot_with_secret + exact _message_from_dot)
// ct: (size, k, n); s_ntt: (k, n) NTT form (first k limbs of the secret key).
// out: (n,) plaintext mod t.
// ---------------------------------------------------------------------------

void he_decrypt(void* h, const u64* ct, u64 size, const u64* s_ntt, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    u64* dot = scratch(15, c.k * n);
    u64* acc = scratch(16, n);
    u64* term = scratch(17, n);
    u64* cur = scratch(18, n);
    for (size_t j = 0; j < c.k; ++j) {
        const u64 p = c.qm[j];
        const Table& tb = c.tab(p);
        const Barrett& br = c.bar(p);
        const u64* s = s_ntt + j * n;
        std::memcpy(cur, s, n * sizeof(u64));
        std::memset(acc, 0, n * sizeof(u64));
        for (u64 comp = 1; comp < size; ++comp) {
            std::memcpy(term, ct + (comp * c.k + j) * n,
                        n * sizeof(u64));
            ntt_inplace(tb, term);
            for (u64 i = 0; i < n; ++i)
                acc[i] = addmod(acc[i], br.mul(term[i], cur[i]), p);
            if (comp + 1 < size)
                for (u64 i = 0; i < n; ++i) cur[i] = br.mul(cur[i], s[i]);
        }
        intt_inplace(tb, acc);
        const u64* c0 = ct + j * n;
        u64* d = dot + j * n;
        for (u64 i = 0; i < n; ++i) d[i] = addmod(c0[i], acc[i], p);
    }
    // exact CRT compose + round(t*x/q) mod t (golden._message_from_dot)
    const u128 q = c.q;
    const u128 q_half = q >> 1;
    for (u64 i = 0; i < n; ++i) {
        u128 S = 0;
        for (size_t j = 0; j < c.k; ++j) {
            const Barrett& br = c.bar(c.qm[j]);
            u64 y = br.mul(dot[j * n + i], c.q_hat_inv[j]);
            S += c.q_hat[j] * y;           // < k*q <= 4q < 2^124
        }
        while (S >= q) S -= q;             // <= k-1 subtractions
        // m = floor((t*S + q/2) / q) % t, exact in u192
        u192 N = u192_add(u192_mul_small(c.t, S), u192_from_u128(q_half));
        u64 mraw = u192_div_u128_small(N, q);
        out[i] = mraw % c.t;
    }
}

// ---------------------------------------------------------------------------
// BEHZ multiply (golden.multiply): (2,k,n) x (2,k,n) -> (3,k,n)
// ---------------------------------------------------------------------------

void he_multiply(void* h, const u64* a, const u64* b, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    const size_t k = c.k, nbsk = c.bsk.size(), nb = k + nbsk;
    std::vector<u64> bases(c.qm);
    for (u64 x : c.bsk) bases.push_back(x);

    // extend both operands into q + Bsk residues (golden.multiply extend())
    u64* ea = scratch(0, 2 * nb * n);
    u64* eb = scratch(1, 2 * nb * n);
    for (int comp = 0; comp < 2; ++comp) {
        std::memcpy(ea + comp * nb * n, a + comp * k * n,
                    k * n * sizeof(u64));
        std::memcpy(eb + comp * nb * n, b + comp * k * n,
                    k * n * sizeof(u64));
        to_bsk(c, a + comp * k * n, ea + (comp * nb + k) * n);
        to_bsk(c, b + comp * k * n, eb + (comp * nb + k) * n);
    }

    // tensor products per base, NTT domain (schoolbook, as golden).
    // ea/eb are dead after this stage, so the NTTs run in place on them.
    u64* prod = scratch(2, 3 * nb * n);
    for (size_t xi = 0; xi < nb; ++xi) {
        const u64 p = bases[xi];
        const Table& tb = c.tab(p);
        const Barrett& br = c.bar(p);
        u64* a0 = ea + (0 * nb + xi) * n;
        u64* a1 = ea + (1 * nb + xi) * n;
        u64* b0 = eb + (0 * nb + xi) * n;
        u64* b1 = eb + (1 * nb + xi) * n;
        ntt_inplace(tb, a0);
        ntt_inplace(tb, a1);
        ntt_inplace(tb, b0);
        ntt_inplace(tb, b1);
        u64* p0 = prod + (0 * nb + xi) * n;
        u64* p1 = prod + (1 * nb + xi) * n;
        u64* p2 = prod + (2 * nb + xi) * n;
#ifdef HE_HAVE_AVX512
        if (n % 8 == 0 && cpu_has_ifma()) {
            // Montgomery-IFMA products, lazy in [0, 2p); intt_avx512
            // accepts < 2p inputs and canonicalizes on the way out.
            vec_dyadic_avx512(a0, a1, b0, b1, n, p, p0, p1, p2);
            intt_inplace(tb, p0);
            intt_inplace(tb, p1);
            intt_inplace(tb, p2);
            continue;
        }
#endif
        for (u64 i = 0; i < n; ++i) {
            p0[i] = br.mul(a0[i], b0[i]);
            p1[i] = addmod(br.mul(a0[i], b1[i]), br.mul(a1[i], b0[i]), p);
            p2[i] = br.mul(a1[i], b1[i]);
        }
        intt_inplace(tb, p0);
        intt_inplace(tb, p1);
        intt_inplace(tb, p2);
    }

    // FastFloor + Shenoy-Kumaresan per component
#ifdef HE_HAVE_AVX512
    const bool vec = (n % 8 == 0) && cpu_has_ifma();
#else
    const bool vec = false;
#endif
    u64* tq = scratch(3, nb * n);
    u64* conv = scratch(4, nbsk * n);
    u64* floor_bsk = scratch(5, nbsk * n);
    for (int comp = 0; comp < 3; ++comp) {
        for (size_t xi = 0; xi < nb; ++xi) {
            const u64 p = bases[xi];
            const u64* src = prod + (comp * nb + xi) * n;
            u64* dst = tq + xi * n;
            const u64 tmod = c.t % p;
#ifdef HE_HAVE_AVX512
            if (vec) { vec_mulc_avx512(dst, src, n, tmod, p); continue; }
#endif
            const Barrett& br = c.bar(p);
            for (u64 i = 0; i < n; ++i) dst[i] = br.mul(src[i], tmod);
        }
        fastbconv_q(c, tq, c.bsk, conv);
        for (size_t xi = 0; xi < nbsk; ++xi) {
            const u64 x = c.bsk[xi];
            const u64 iq = c.inv_q_mod_x.at(x);
            const u64* tqx = tq + (k + xi) * n;
            const u64* cv = conv + xi * n;
            u64* fb = floor_bsk + xi * n;
#ifdef HE_HAVE_AVX512
            if (vec) { vec_submulc_avx512(fb, tqx, cv, n, iq, x); continue; }
#endif
            const Barrett& br = c.bar(x);
            for (u64 i = 0; i < n; ++i)
                fb[i] = br.mul(submod(tqx[i], cv[i], x), iq);
        }
        fastbconv_sk(c, floor_bsk, out + comp * k * n);
    }
}

// ---------------------------------------------------------------------------
// relinearization (golden.relinearize): (3,k,n) + rk (k,2,k_key,n) -> (2,k,n)
// ---------------------------------------------------------------------------

void he_relinearize(void* h, const u64* ct, const u64* rk, u64* out) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    const size_t k = c.k, kk = c.k_key;
#ifdef HE_HAVE_AVX512
    const bool vec = (n % 8 == 0) && cpu_has_ifma();
#else
    const bool vec = false;
#endif
    u64* acc = scratch(13, 2 * kk * n);
    std::memset(acc, 0, 2 * kk * n * sizeof(u64));
    u64* dji = scratch(14, n);
    for (size_t j = 0; j < k; ++j) {
        const u64* dj = ct + (2 * k + j) * n;
        for (size_t i = 0; i < kk; ++i) {
            const u64 p = c.keym[i];
            const Table& tb = c.tab(p);
            const Barrett& br = c.bar(p);
            const u64* rk0 = rk + ((j * 2 + 0) * kk + i) * n;
            const u64* rk1 = rk + ((j * 2 + 1) * kk + i) * n;
            u64* a0 = acc + (0 * kk + i) * n;
            u64* a1 = acc + (1 * kk + i) * n;
#ifdef HE_HAVE_AVX512
            if (vec) {
                // dj < q_j < 2^37 fits the 52-bit domain directly.
                std::memcpy(dji, dj, n * sizeof(u64));
                vec_reduce_avx512(dji, n, p);
                ntt_inplace(tb, dji);
                // Montgomery inner product: lift dji by 2^52 once, then
                // accumulate k <= 4 lazy (< 2p) terms per component.
                const u64 r52 = (u64)((((u128)1) << 52) % p);
                vec_mulc_lazy_avx512(dji, dji, n, r52, p);
                vec_addmont_avx512(a0, dji, rk0, n, p);
                vec_addmont_avx512(a1, dji, rk1, n, p);
                continue;
            }
#endif
            for (u64 x = 0; x < n; ++x) dji[x] = br.reduce64(dj[x]);
            ntt_inplace(tb, dji);
            for (u64 x = 0; x < n; ++x) {
                a0[x] = addmod(a0[x], br.mul(dji[x], rk0[x]), p);
                a1[x] = addmod(a1[x], br.mul(dji[x], rk1[x]), p);
            }
        }
    }
    for (size_t i = 0; i < kk; ++i) {
        const Table& tb = c.tab(c.keym[i]);
        u64* a0 = acc + (0 * kk + i) * n;
        u64* a1 = acc + (1 * kk + i) * n;
#ifdef HE_HAVE_AVX512
        if (vec) {   // lazy accumulators (< 8p) -> canonical before intt
            vec_reduce_avx512(a0, n, c.keym[i]);
            vec_reduce_avx512(a1, n, c.keym[i]);
        }
#endif
        intt_inplace(tb, a0);
        intt_inplace(tb, a1);
    }
    // divide by the special prime P with rounding (golden.relinearize)
    const u64 P = c.P, half = c.P_half;
    for (int comp = 0; comp < 2; ++comp) {
        const u64* xP = acc + (comp * kk + (kk - 1)) * n;
        for (size_t i = 0; i < k; ++i) {
            const u64 p = c.qm[i];
            const u64 halfp = c.half_mod_q[i];
            const u64 ipq = c.inv_P_mod_q[i];
            const u64* ai = acc + (comp * kk + i) * n;
            const u64* cti = ct + (comp * k + i) * n;
            u64* o = out + (comp * k + i) * n;
#ifdef HE_HAVE_AVX512
            if (vec) {
                vec_relin_pdiv_avx512(o, cti, ai, xP, n, p, P, half, halfp,
                                      ipq);
                continue;
            }
#endif
            const Barrett& br = c.bar(p);
            for (u64 x = 0; x < n; ++x) {
                u64 xph = addmod(xP[x], half, P);
                u64 corr = submod(xph % p, halfp, p);
                u64 ti = submod(ai[x], corr, p);
                o[x] = addmod(cti[x], br.mul(ti, ipq), p);
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// key generation (golden.generate_keys + _generate_relin_keys)
// ---------------------------------------------------------------------------

namespace {

// Uniform values in [0, p) by rejection from u64 -- byte-identical stream
// consumption to sampling.sample_uniform_mod (each round reads
// need + need//8 + 8 u64 words; surplus accepted words are discarded with
// their bytes consumed, exactly as the numpy slicing does).
static void sample_uniform_mod_xof(Xof& xof, u64 p, u64 n, u64* out) {
    const u64 rem = (u64)((((u128)1) << 64) % p);
    const u64 bound = (u64)((((u128)1) << 64) - rem);
    u64 filled = 0;
    std::vector<u64> draws;
    while (filled < n) {
        const u64 need = n - filled;
        draws.resize(need + need / 8 + 8);
        xof.read((uint8_t*)draws.data(), draws.size() * 8);
        for (size_t i = 0; i < draws.size() && filled < n; ++i)
            if (draws[i] < bound) out[filled++] = draws[i];
    }
    for (u64 i = 0; i < n; ++i) out[i] %= p;
}

}  // namespace

extern "C" {

// Keygen, bit-identical to golden.generate_keys for the same seed:
//   s_ntt (k_key, n)   ternary secret, NTT form per key modulus
//   pk    (2, k_key, n) NTT form: pk0 = -(a*s + e), pk1 = a
//   rk    (k, 2, k_key, n) or NULL: SEAL-convention relin keys
//          (key_j = enc_zero + P*s^2 embedded in decomposition limb j)
// Domain tags + CBD parameter are passed in (protocol constants live in
// sampling.py; the engine stays format-agnostic like the other samplers).
// rk is written only when want_relin != 0 AND the context has a special
// prime; the uniform/error streams are shared sequentially across pk and
// relin draws exactly as golden's xof_a/xof_e are.
void he_keygen(void* h, const uint8_t* seed, u64 dom_keygen, u64 dom_uniform,
               u64 dom_error, u64 kcbd, int want_relin,
               u64* s_ntt, u64* pk, u64* rk) {
    const Ctx& c = *(const Ctx*)h;
    const u64 n = c.n;
    const size_t kk = c.k_key, k = c.k;

    std::vector<i64> s(n);
    he_sample_ternary(seed, dom_keygen, n, s.data());
    for (size_t i = 0; i < kk; ++i) {
        const u64 p = c.keym[i];
        u64* dst = s_ntt + i * n;
        for (u64 x = 0; x < n; ++x) dst[x] = fmod_signed(s[x], p);
        ntt_inplace(c.tab(p), dst);
    }

    Xof xof_a(seed, dom_uniform);
    Xof xof_e(seed, dom_error);
    std::vector<i64> e(n);
    std::vector<u64> a(n), entt(n);

    sample_cbd_once(xof_e, n, kcbd, e.data());
    for (size_t i = 0; i < kk; ++i) {
        const u64 p = c.keym[i];
        const Barrett& br = c.bar(p);
        sample_uniform_mod_xof(xof_a, p, n, a.data());
        for (u64 x = 0; x < n; ++x) entt[x] = fmod_signed(e[x], p);
        ntt_inplace(c.tab(p), entt.data());
        const u64* si = s_ntt + i * n;
        u64* pk0 = pk + i * n;
        u64* pk1 = pk + (kk + i) * n;
        for (u64 x = 0; x < n; ++x) {
            pk0[x] = negmod(addmod(br.mul(a[x], si[x]), entt[x], p), p);
            pk1[x] = a[x];
        }
    }

    if (!want_relin || !c.has_special || rk == nullptr) return;
    for (size_t j = 0; j < k; ++j) {
        sample_cbd_once(xof_e, n, kcbd, e.data());
        for (size_t i = 0; i < kk; ++i) {
            const u64 p = c.keym[i];
            const Barrett& br = c.bar(p);
            sample_uniform_mod_xof(xof_a, p, n, a.data());
            for (u64 x = 0; x < n; ++x) entt[x] = fmod_signed(e[x], p);
            ntt_inplace(c.tab(p), entt.data());
            const u64* si = s_ntt + i * n;
            u64* rk0 = rk + ((j * 2 + 0) * kk + i) * n;
            u64* rk1 = rk + ((j * 2 + 1) * kk + i) * n;
            for (u64 x = 0; x < n; ++x) {
                rk0[x] = negmod(addmod(br.mul(a[x], si[x]), entt[x], p), p);
                rk1[x] = a[x];
            }
        }
        // embed P * s^2 into decomposition limb j
        const u64 pj = c.qm[j];
        const Barrett& brj = c.bar(pj);
        const u64 p_mod = (u64)(c.P % pj);
        const u64* sj = s_ntt + j * n;
        u64* rk0j = rk + ((j * 2 + 0) * kk + j) * n;
        for (u64 x = 0; x < n; ++x) {
            u64 term = brj.mul(brj.mul(sj[x], sj[x]), p_mod);
            rk0j[x] = addmod(rk0j[x], term, pj);
        }
    }
}

}  // extern "C"

// Pure-native C ABI and batched host codec: the 51-symbol precompile
// surface with NO Python dependency, plus the fhe_tpu_* codec extension
// that ByteServer(codec="native") drives (native/codec.py).
//
// The port's copy of the JAX package's fhe_precompiles_tpu/native/
// precompiles.cpp.  What differs from it: the library reads no environment
// variable.  Network keys come in through fhe_tpu_init_keys, else from the
// package's data/ directory found relative to this library (which sits in
// fhe_precompiles_tpu_torch/_build/); a zstd build other than the linked
// one comes in only through fhe_tpu_use_libzstd(path).
//
// Parity target: the reference's src/c_fhe.rs (symbols + signatures + error
// codes) and the full byte path behind it -- calldata framing (pack.rs),
// bincode/SEAL/zstd serialization, plaintext encodings, SHA-512 threshold
// seeding (fhe.rs:594-699) -- implemented end-to-end in C++ over the native
// BFV engine (host_engine.cpp).
//
// Byte-exactness contract: every (code, payload) this file returns must be
// identical to FheApp.call(name, input) (tests/test_torch_native_codec.py
// and tests/test_torch_serve_native.py hold the codec halves and the
// server to the port's FheApp and the JAX package's golden app).  The
// Python modules mirrored here, cited per section:
//   pack.py (wire framing)          serialization/bincode.py (bincode subset)
//   serialization/seal.py (SEAL 4.x blobs + zstd)
//   serialization/keyio.py (sunscreen-level key/ct containers)
//   encoding.py (plaintext types)   app.py (FheApp op logic + error mapping)
//   params.py (preset + BEHZ aux-base derivation)
//
// zstd note: frames are emitted with the single-shot simple API at level 3
// with content size, which produces byte-identical output to Python
// zstandard's ZstdCompressor(write_content_size=True) on a canonical build
// (zstd_canonical.h; fhe_tpu_zstd_canonical() reports the active build).

#include <dlfcn.h>
#include "zstd_decls.h"  // the libzstd calls used here (no zstd.h needed)

#include "c_fhe.h"  // the public 51-symbol surface (prototypes + X-macro)
#include "zstd_canonical.h"  // canonical zstd frame hashes (generated)

#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

typedef uint8_t u8;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;
typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// host_engine.cpp extern-C surface (compiled into the same .so)
// ---------------------------------------------------------------------------
extern "C" {
void* he_ctx_new(u64 n, u64 t, const u64* q_mods, u64 k, const u64* key_mods,
                 u64 k_key, const u64* aux, u64 n_aux, u64 m_sk, u64 m_tilde);
void he_ctx_free(void* h);
void he_add(void* h, const u64* a, const u64* b, u64 size, u64* out);
void he_sub(void* h, const u64* a, const u64* b, u64 size, u64* out);
void he_neg(void* h, const u64* a, u64 size, u64* out);
void he_plain_affine(void* h, const u64* a, u64 size, const u64* m, int mode,
                     u64* out);
void he_mul_plain(void* h, const u64* a, u64 size, const u64* m, u64* out);
void he_encrypt(void* h, const u64* m, const i64* u, const i64* e0,
                const i64* e1, const u64* pk, u64 k_key_stride, u64* out);
void he_decrypt(void* h, const u64* ct, u64 size, const u64* s_ntt, u64* out);
void he_multiply(void* h, const u64* a, const u64* b, u64* out);
void he_relinearize(void* h, const u64* ct, const u64* rk, u64* out);
void he_sample_ternary(const u8* seed, u64 domain, u64 n, i64* out);
void he_sample_cbd_pair(const u8* seed, u64 domain, u64 n, u64 kcbd, i64* e0,
                        i64* e1);
}

namespace fheabi {

// ---------------------------------------------------------------------------
// error model (errors.py / lib.rs:14-27)
//
// FheErr  = Python FheError: carries a stable code that propagates verbatim.
// GenericErr = any non-FheError Python exception: the catch site decides the
// code (binary ops -> 7, encrypt side -> 6, decrypt side -> 5), mirroring
// app.py's try/except structure exactly.
// ---------------------------------------------------------------------------
struct FheErr {
  int code;
};
struct GenericErr {};

[[noreturn]] static void eof_err() { throw FheErr{1}; }
[[noreturn]] static void enc_err() { throw FheErr{3}; }
[[noreturn]] static void ovf_err() { throw FheErr{4}; }

// ---------------------------------------------------------------------------
// SHA-512 (FIPS 180-4), incremental -- seed derivation (app.py:206-209,
// fhe.rs:600-611).  Runs on host-side bytes only; any standard impl matches.
// ---------------------------------------------------------------------------
namespace sha512 {

static const u64 K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

static inline u64 rotr(u64 x, int r) { return (x >> r) | (x << (64 - r)); }

struct Ctx {
  u64 h[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
              0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
              0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
              0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  u8 buf[128];
  size_t buflen = 0;
  u64 total = 0;  // bytes (inputs here are far below 2^61)

  void block(const u8* p) {
    u64 w[80];
    for (int i = 0; i < 16; ++i) {
      w[i] = 0;
      for (int j = 0; j < 8; ++j) w[i] = (w[i] << 8) | p[8 * i + j];
    }
    for (int i = 16; i < 80; ++i) {
      u64 s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
      u64 s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
        hh = h[7];
    for (int i = 0; i < 80; ++i) {
      u64 S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
      u64 ch = (e & f) ^ (~e & g);
      u64 t1 = hh + S1 + ch + K[i] + w[i];
      u64 S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
      u64 maj = (a & b) ^ (a & c) ^ (b & c);
      u64 t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const u8* p, size_t len) {
    total += len;
    while (len) {
      size_t take = 128 - buflen;
      if (take > len) take = len;
      std::memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      len -= take;
      if (buflen == 128) {
        block(buf);
        buflen = 0;
      }
    }
  }

  void final(u8 out[64]) {
    u64 bits = total * 8;  // captured before padding; later updates are pad
    u8 pad = 0x80;
    update(&pad, 1);
    u8 z = 0;
    while (buflen != 112) update(&z, 1);
    u8 len_be[16] = {0};
    for (int i = 0; i < 8; ++i) len_be[15 - i] = (u8)(bits >> (8 * i));
    update(len_be, 16);
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) out[8 * i + j] = (u8)(h[i] >> (56 - 8 * j));
  }
};

}  // namespace sha512

// ---------------------------------------------------------------------------
// BLAKE2b-256 over a single block (msg <= 128 B) -- parms_id computation
// (seal.py:43-47: BLAKE2b digest_size=32 over LE u64 words).
// ---------------------------------------------------------------------------
namespace b2b {

static const u64 IV[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
                          0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
                          0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                          0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const u8 SIGMA[12][16] = {
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

static inline void G(u64* v, int a, int b, int c, int d, u64 x, u64 y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

static void compress(u64 h[8], const u8 blk[128], u64 t, bool last) {
  u64 m[16], v[16];
  for (int i = 0; i < 16; ++i) std::memcpy(&m[i], blk + 8 * i, 8);
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = IV[i];
  }
  v[12] ^= t;  // byte counter low word (inputs here are far below 2^64)
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; ++r) {
    const u8* s = SIGMA[r];
    G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// digest_size = 32, unkeyed, any message length (hashlib.blake2b parity:
// a wire-valid public key may carry arbitrarily many moduli, so the
// parms_id input (3 + #moduli) * 8 bytes can exceed one 128-byte block;
// the single-block shortcut used to diverge from Python at 14+ moduli).
static void hash32(const u8* msg, size_t len, u8 out[32]) {
  u64 h[8];
  for (int i = 0; i < 8; ++i) h[i] = IV[i];
  h[0] ^= 0x01010020ULL;  // digest 32, key 0, fanout 1, depth 1
  size_t off = 0;
  while (len - off > 128) {  // full non-final blocks
    compress(h, msg + off, (u64)(off + 128), false);
    off += 128;
  }
  u8 blk[128] = {0};
  std::memcpy(blk, msg + off, len - off);
  compress(h, blk, (u64)len, true);
  for (int i = 0; i < 4; ++i) std::memcpy(out + 8 * i, &h[i], 8);
}

}  // namespace b2b

// ---------------------------------------------------------------------------
// Minimal arbitrary-precision unsigned integer.  Two consumers only:
//   * the BEHZ aux-base bound checks (params.py:119-141) -- must agree with
//     Python's exact big-int comparisons or validators derive different
//     bases (consensus break), and
//   * plaintext decode composition (encoding.py:35-53) -- sums of c_i * 2^i
//     over up to n coefficients.
// Little-endian u64 limbs, value-semantics, no performance ambitions (both
// call sites are O(once) or O(n) small-word work).
// ---------------------------------------------------------------------------
struct BigU {
  std::vector<u64> w;  // little-endian limbs; empty == 0

  static BigU from_u64(u64 v) {
    BigU r;
    if (v) r.w.push_back(v);
    return r;
  }
  bool zero() const { return w.empty(); }
  void trim() {
    while (!w.empty() && w.back() == 0) w.pop_back();
  }
  size_t bitlen() const {
    if (w.empty()) return 0;
    return 64 * (w.size() - 1) + (64 - __builtin_clzll(w.back()));
  }
  bool bit(size_t i) const {
    size_t idx = i / 64;
    if (idx >= w.size()) return false;
    return (w[idx] >> (i % 64)) & 1;
  }
  // -1 / 0 / +1 for this <=> o
  int cmp(const BigU& o) const {
    if (w.size() != o.w.size()) return w.size() < o.w.size() ? -1 : 1;
    for (size_t i = w.size(); i-- > 0;)
      if (w[i] != o.w[i]) return w[i] < o.w[i] ? -1 : 1;
    return 0;
  }
  void add(const BigU& o) {
    if (o.w.size() > w.size()) w.resize(o.w.size(), 0);
    unsigned char carry = 0;
    for (size_t i = 0; i < w.size(); ++i) {
      u64 ov = i < o.w.size() ? o.w[i] : 0;
      u64 t;
      unsigned char c1 = __builtin_add_overflow(w[i], ov, &t);
      unsigned char c2 = __builtin_add_overflow(t, (u64)carry, &w[i]);
      carry = (unsigned char)(c1 | c2);
    }
    if (carry) w.push_back(1);
  }
  void sub(const BigU& o) {  // requires *this >= o
    unsigned char borrow = 0;
    for (size_t i = 0; i < w.size(); ++i) {
      u64 ov = i < o.w.size() ? o.w[i] : 0;
      u64 t;
      unsigned char b1 = __builtin_sub_overflow(w[i], ov, &t);
      unsigned char b2 = __builtin_sub_overflow(t, (u64)borrow, &w[i]);
      borrow = (unsigned char)(b1 | b2);
    }
    trim();
  }
  void mul_u64(u64 m) {
    if (m == 0) {
      w.clear();
      return;
    }
    u64 carry = 0;
    for (size_t i = 0; i < w.size(); ++i) {
      u128 p = (u128)w[i] * m + carry;
      w[i] = (u64)p;
      carry = (u64)(p >> 64);
    }
    if (carry) w.push_back(carry);
  }
  BigU mul(const BigU& o) const {
    BigU r;
    if (zero() || o.zero()) return r;
    r.w.assign(w.size() + o.w.size(), 0);
    for (size_t i = 0; i < w.size(); ++i) {
      u64 carry = 0;
      for (size_t j = 0; j < o.w.size(); ++j) {
        u128 p = (u128)w[i] * o.w[j] + r.w[i + j] + carry;
        r.w[i + j] = (u64)p;
        carry = (u64)(p >> 64);
      }
      r.w[i + o.w.size()] += carry;
    }
    r.trim();
    return r;
  }
  void shl_bits(size_t s) {
    if (zero() || s == 0) return;
    size_t limb = s / 64, off = s % 64;
    std::vector<u64> nw(w.size() + limb + 1, 0);
    for (size_t i = 0; i < w.size(); ++i) {
      nw[i + limb] |= off ? (w[i] << off) : w[i];
      if (off) nw[i + limb + 1] |= w[i] >> (64 - off);
    }
    w = std::move(nw);
    trim();
  }
  // this += v << bitpos  (v any u64)
  void add_shifted(u64 v, size_t bitpos) {
    if (v == 0) return;
    size_t idx = bitpos / 64, off = bitpos % 64;
    if (w.size() < idx + 3) w.resize(idx + 3, 0);
    u64 lo = off ? (v << off) : v;
    u64 hi = off ? (v >> (64 - off)) : 0;
    unsigned char c = __builtin_add_overflow(w[idx], lo, &w[idx]);
    u64 t;
    unsigned char c1 = __builtin_add_overflow(w[idx + 1], hi, &t);
    unsigned char c2 = __builtin_add_overflow(t, (u64)c, &w[idx + 1]);
    size_t i = idx + 2;
    u64 carry = (u64)(c1 | c2);
    while (carry) {
      if (i >= w.size()) w.push_back(0);
      carry = __builtin_add_overflow(w[i], carry, &w[i]);
      ++i;
    }
    trim();
  }
  // floor(this / d); remainder in *rem.  Binary long division -- the only
  // caller is the one-time aux-base derivation.
  BigU divmod(const BigU& d, BigU* rem) const {
    BigU q, r;
    size_t nbits = bitlen();
    for (size_t i = nbits; i-- > 0;) {
      r.shl_bits(1);
      if (bit(i)) {
        if (r.w.empty()) r.w.push_back(0);
        r.w[0] |= 1;
      }
      if (r.cmp(d) >= 0) {
        r.sub(d);
        q.add_shifted(1, i);
      }
    }
    if (rem) *rem = r;
    return q;
  }
  u64 mod_u64(u64 m) const {
    u128 r = 0;
    for (size_t i = w.size(); i-- > 0;) r = ((r << 64) | w[i]) % m;
    return (u64)r;
  }
  u64 low_u64() const { return w.empty() ? 0 : w[0]; }
  // mag >> s, collecting guard (bit s-1) and sticky (any bit below s-1);
  // result must fit u64 (caller guarantees bitlen - s <= 64).
  u64 shr_collect(size_t s, bool* guard, bool* sticky) const {
    *guard = s >= 1 && bit(s - 1);
    bool st = false;
    for (size_t i = 0; i + 1 < s && !st; ++i) st = bit(i);
    // (linear scan is fine: s <= ~4100 bits, one-time per decode)
    *sticky = st;
    u64 out = 0;
    size_t nbits = bitlen();
    for (size_t i = s; i < nbits; ++i)
      if (bit(i)) out |= 1ULL << (i - s);
    return out;
  }
};

// ---------------------------------------------------------------------------
// bincode subset (serialization/bincode.py): fixed-width LE ints, Vec<u8> as
// u64 length + raw bytes, Option<T> as a 1-byte tag.  Truncation -> code 3.
// ---------------------------------------------------------------------------
struct View {
  const u8* p = nullptr;
  size_t len = 0;
};

struct Reader {
  const u8* d;
  size_t len, off = 0;

  Reader(const u8* data, size_t n) : d(data), len(n) {}
  const u8* take(size_t n) {
    if (off + n > len) enc_err();  // "bincode input truncated"
    const u8* r = d + off;
    off += n;
    return r;
  }
  u8 rd_u8() { return take(1)[0]; }
  u32 rd_u32() {
    u32 v;
    std::memcpy(&v, take(4), 4);
    return v;  // little-endian host
  }
  u64 rd_u64() {
    u64 v;
    std::memcpy(&v, take(8), 8);
    return v;
  }
  View byte_vec() {
    u64 n = rd_u64();
    if (n > len - off) enc_err();
    return View{take((size_t)n), (size_t)n};
  }
  bool option() {
    u8 tag = rd_u8();
    if (tag > 1) enc_err();  // "bad Option tag"
    return tag == 1;
  }
  void expect_end() const {
    if (off != len) enc_err();  // "trailing bytes"
  }
};

struct Writer {
  std::vector<u8> out;

  void raw(const u8* p, size_t n) { out.insert(out.end(), p, p + n); }
  void wr_u8(u8 v) { out.push_back(v); }
  void wr_u32(u32 v) { raw((const u8*)&v, 4); }
  void wr_u64(u64 v) { raw((const u8*)&v, 8); }
  void wr_f64(double v) { raw((const u8*)&v, 8); }
  void byte_vec(const std::vector<u8>& b) {
    wr_u64(b.size());
    raw(b.data(), b.size());
  }
};

// ---------------------------------------------------------------------------
// Params (params.py): n, full coeff base (special prime last), t.
// ct_moduli drops the special prime when >1 modulus; key_moduli = all.
// ---------------------------------------------------------------------------
struct Params {
  u64 n = 0;
  std::vector<u64> coeff;
  u64 t = 0;

  size_t k_key() const { return coeff.size(); }
  size_t k_ct() const { return coeff.size() > 1 ? coeff.size() - 1 : coeff.size(); }
  std::vector<u64> ct_moduli() const {
    return std::vector<u64>(coeff.begin(), coeff.begin() + k_ct());
  }
  bool operator==(const Params& o) const {
    return n == o.n && t == o.t && coeff == o.coeff;
  }
  bool operator!=(const Params& o) const { return !(*this == o); }

  // params.py validate(): untrusted wire params must satisfy the arithmetic
  // preconditions before anything computes (keyio.py:66-70 -> code 3).
  void validate() const {
    if (n < 8 || (n & (n - 1))) enc_err();
    for (size_t i = 0; i < coeff.size(); ++i) {
      u64 p = coeff[i];
      if (p % (2 * n) != 1) enc_err();
      if (p >= (1ULL << 37)) enc_err();
      for (size_t j = 0; j < i; ++j)
        if (coeff[j] == p) enc_err();  // duplicate moduli
    }
  }
};

// keyio.read_params / write_params: { n u64, Vec<u64>, t u64, scheme u32(0),
// security u32(0) } -- verified against the reference key blobs.
static Params read_params(Reader& r) {
  Params p;
  p.n = r.rd_u64();
  u64 count = r.rd_u64();
  // No arbitrary count cap: Python keyio.read_params has none, and a cap
  // here split error-code consensus at 65+ moduli.  A huge wire count is
  // naturally bounded by the input length (rd_u64 EOF -> code 3).
  for (u64 i = 0; i < count; ++i) p.coeff.push_back(r.rd_u64());
  p.t = r.rd_u64();
  if (r.rd_u32() != 0) enc_err();  // scheme tag: bfv only
  if (r.rd_u32() != 0) enc_err();  // security tag: tc128 only
  p.validate();
  return p;
}

static void write_params(Writer& w, const Params& p) {
  w.wr_u64(p.n);
  w.wr_u64(p.coeff.size());
  for (u64 m : p.coeff) w.wr_u64(m);
  w.wr_u64(p.t);
  w.wr_u32(0);
  w.wr_u32(0);
}

// ---------------------------------------------------------------------------
// SEAL 4.x stream codec (serialization/seal.py): 16-byte header + payload,
// zstd frames byte-identical to Python zstandard level-3 with content size.
// ---------------------------------------------------------------------------
static const u64 SEAL_MAGIC = 0xA15E;
static const int COMPR_NONE = 0, COMPR_ZSTD = 2;
static const size_t HEADER_SIZE = 16;

static void pack_header(Writer& w, u64 total_size, int compr) {
  w.wr_u8(0x5E);  // magic u16 LE
  w.wr_u8(0xA1);
  w.wr_u8(16);                  // header_size
  w.wr_u8(4);                   // ver major
  w.wr_u8(0);                   // ver minor
  w.wr_u8((u8)compr);           // compr_mode
  w.wr_u8(0);                   // reserved u16
  w.wr_u8(0);
  w.wr_u64(total_size);
}

// returns (total_size, compr_mode)
static void unpack_header(const u8* d, size_t len, size_t off, u64* size,
                          int* compr) {
  if (len - off < HEADER_SIZE) enc_err();  // "SEAL header truncated"
  u64 magic = d[off] | ((u64)d[off + 1] << 8);
  u8 hsz = d[off + 2];
  if (magic != SEAL_MAGIC || hsz != HEADER_SIZE) enc_err();
  *compr = d[off + 5];
  std::memcpy(size, d + off + 8, 8);
}

// Runtime-selectable zstd build.  The image's system libzstd (1.5.4) runs
// the level-3 compress of a ~131 KB ciphertext payload ~1.45x slower than
// the 1.5.7 builds shipped inside Python wheels; the frames are
// byte-identical at level 3 either way (pinned by tests).  Since the
// encode side of the serving codec is zstd-floor-bound, the codec lets an
// operator (or NativeCodec's automatic probe of python-zstandard's _cffi
// extension) swap in a faster library at runtime — but ONLY after
// byte-verifying its frames against the linked library on probe payloads:
// the compressed bytes are consensus-critical, so a candidate that
// compresses differently is rejected, never trusted.
struct ZstdApi {
  ZSTD_CCtx* (*createCCtx)(void);
  size_t (*freeCCtx)(ZSTD_CCtx*);
  size_t (*compressCCtx)(ZSTD_CCtx*, void*, size_t, const void*, size_t,
                         int);
  ZSTD_DCtx* (*createDCtx)(void);
  size_t (*freeDCtx)(ZSTD_DCtx*);
  size_t (*decompressDCtx)(ZSTD_DCtx*, void*, size_t, const void*, size_t);
  unsigned long long (*getFrameContentSize)(const void*, size_t);
  unsigned (*isError)(size_t);
  size_t (*compressBound)(size_t);
};
static const ZstdApi LINKED_ZSTD = {
    ZSTD_createCCtx,      ZSTD_freeCCtx, ZSTD_compressCCtx,
    ZSTD_createDCtx,      ZSTD_freeDCtx, ZSTD_decompressDCtx,
    ZSTD_getFrameContentSize, ZSTD_isError, ZSTD_compressBound};
static std::atomic<const ZstdApi*> g_zstd{&LINKED_ZSTD};

// zstd contexts are ~MB workspaces; cache per thread (seal.py:67-86).
// RAII holders, NOT bare thread_local pointers: short-lived worker
// threads (one pool per ByteServer.run once leaked ~2 MB per thread in
// never-freed contexts — measured as ~4 MB/window RSS growth in the
// serving soak test).  Each holder captures the API it created its
// context with, so a swap never frees a context with the other library.
struct TlsCCtx {
  const ZstdApi* api = g_zstd.load(std::memory_order_acquire);
  ZSTD_CCtx* p = api->createCCtx();
  ~TlsCCtx() { api->freeCCtx(p); }
};
struct TlsDCtx {
  const ZstdApi* api = g_zstd.load(std::memory_order_acquire);
  ZSTD_DCtx* p = api->createDCtx();
  ~TlsDCtx() { api->freeDCtx(p); }
};
static TlsCCtx& tls_cctx() {
  thread_local TlsCCtx c;
  // follow a swap immediately (one atomic load per call): rebuild this
  // thread's context with the now-active library
  const ZstdApi* cur = g_zstd.load(std::memory_order_acquire);
  if (cur != c.api) {
    c.api->freeCCtx(c.p);
    c.api = cur;
    c.p = cur->createCCtx();
  }
  return c;
}
static TlsDCtx& tls_dctx() {
  thread_local TlsDCtx c;
  const ZstdApi* cur = g_zstd.load(std::memory_order_acquire);
  if (cur != c.api) {
    c.api->freeDCtx(c.p);
    c.api = cur;
    c.p = cur->createDCtx();
  }
  return c;
}

static std::vector<u8> wrap_stream(const std::vector<u8>& payload,
                                   bool compress = true) {
  Writer w;
  if (compress) {
    TlsCCtx& c = tls_cctx();
    size_t bound = c.api->compressBound(payload.size());
    std::vector<u8> body(bound);
    size_t r = c.api->compressCCtx(c.p, body.data(), bound, payload.data(),
                                   payload.size(), 3);
    if (c.api->isError(r)) throw GenericErr{};
    body.resize(r);
    pack_header(w, HEADER_SIZE + body.size(), COMPR_ZSTD);
    w.raw(body.data(), body.size());
  } else {
    pack_header(w, HEADER_SIZE + payload.size(), COMPR_NONE);
    w.raw(payload.data(), payload.size());
  }
  return std::move(w.out);
}

static std::vector<u8> unwrap_stream(const u8* d, size_t len) {
  u64 size;
  int compr;
  unpack_header(d, len, 0, &size, &compr);
  if (size != len) enc_err();  // "SEAL stream size mismatch"
  const u8* body = d + HEADER_SIZE;
  size_t body_len = len - HEADER_SIZE;
  if (compr == COMPR_ZSTD) {
    TlsDCtx& dc = tls_dctx();
    unsigned long long csize = dc.api->getFrameContentSize(body, body_len);
    if (csize == ZSTD_CONTENTSIZE_ERROR || csize == ZSTD_CONTENTSIZE_UNKNOWN ||
        csize > (1ULL << 30))
      enc_err();  // zstd failures -> invalid encoding (seal.py:107-111)
    std::vector<u8> out((size_t)csize);
    size_t r = dc.api->decompressDCtx(dc.p, out.data(), out.size(), body,
                                      body_len);
    if (dc.api->isError(r) || r != out.size()) enc_err();
    return out;
  }
  if (compr == COMPR_NONE) return std::vector<u8>(body, body + body_len);
  enc_err();  // unsupported compression mode
}

// ---------------------------------------------------------------------------
// Canonical zstd verification.  Consensus bytes embed zstd level-3 frames,
// and zstd BUILDS diverge on some payloads (system 1.5.4 vs the pinned
// canonical 1.5.7 differ on sparse-centered-noise ciphertext payloads --
// attacker-steerable through any binary op output, so a cross-stack
// consensus split; the reference pins per-platform golden hashes for the
// same reason, fhe.rs:2103-2119).  The canonical build's frame hashes over
// a deterministic probe corpus are checked in (zstd_canonical.h, generated
// by tools/make_zstd_canonical.py; mirrored in Python by
// serialization/zstd_probes.py) and every candidate -- INCLUDING the
// linked library -- is verified against them.
// ---------------------------------------------------------------------------

static std::vector<u8> build_canon_probe(const ZCanonProbe& p) {
  auto xorshift = [](u64& x) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return x;
  };
  // the 73-byte header offset misaligns u64 stores, so values are built
  // aligned and memcpy'd (UBSan-clean; identical bytes, LE hosts)
  if (std::strcmp(p.kind, "residue") == 0) {
    std::vector<u8> out(73 + (size_t)p.count * 8, 0);
    std::vector<u64> v(p.count);
    u64 x = p.seed;
    for (u64 i = 0; i < p.count; ++i)
      v[i] = xorshift(x) & ((1ULL << 37) - 1);
    std::memcpy(out.data() + 73, v.data(), v.size() * 8);
    return out;
  }
  if (std::strcmp(p.kind, "sparse") == 0) {
    // sparse centered noise mod the first testnet modulus -- the measured
    // 1.5.4-vs-1.5.7 divergence window (zstd_probes.py build_probe)
    const u64 P = 0xFFFFEE001ULL;
    std::vector<u8> out(73 + (size_t)p.count * 8, 0);
    std::vector<u64> v(p.count);
    u64 x = p.seed;
    for (u64 i = 0; i < p.count; ++i) {
      u64 r = xorshift(x);
      u64 sel = r & 3;
      v[i] = sel == 0 ? (r >> 2) % 40
             : sel == 1 ? (P - 1) - ((r >> 2) % 39)
                        : 0;
    }
    std::memcpy(out.data() + 73, v.data(), v.size() * 8);
    return out;
  }
  if (std::strcmp(p.kind, "struct") == 0) {
    std::vector<u8> out(p.size);
    for (u64 i = 0; i < p.size; ++i) out[i] = (u8)(i * 7);
    return out;
  }
  if (std::strcmp(p.kind, "zeros") == 0) return std::vector<u8>(p.size, 0);
  // pattern
  std::vector<u8> out(p.size);
  for (u64 i = 0; i < p.size; ++i) out[i] = (u8)((i % 37) * 11 + i / 8192);
  return out;
}

// Does `api` reproduce the canonical frames (and roundtrip them)?
static bool zstd_api_is_canonical(const ZstdApi* api) {
  ZSTD_CCtx* cc = api->createCCtx();
  ZSTD_DCtx* dc = api->createDCtx();
  bool ok = cc && dc;
  for (int i = 0; ok && i < ZCANON_COUNT; ++i) {
    const ZCanonProbe& pr = ZCANON_PROBES[i];
    std::vector<u8> p = build_canon_probe(pr);
    size_t bound = api->compressBound(p.size());
    std::vector<u8> frame(bound);
    size_t r = api->compressCCtx(cc, frame.data(), bound, p.data(), p.size(),
                                 ZCANON_LEVEL);
    if (api->isError(r)) {
      ok = false;
      break;
    }
    u8 digest[64];
    sha512::Ctx h;
    h.update(frame.data(), r);
    h.final(digest);
    if (std::memcmp(digest, pr.sha512, 64) != 0) {
      ok = false;
      break;
    }
    // roundtrip + content-size through the candidate's decode half
    if (api->getFrameContentSize(frame.data(), r) != p.size()) {
      ok = false;
      break;
    }
    std::vector<u8> back(p.size());
    size_t rd = api->decompressDCtx(dc, back.data(), back.size(),
                                    frame.data(), r);
    if (api->isError(rd) || rd != p.size() ||
        (p.size() && std::memcmp(back.data(), p.data(), p.size()) != 0))
      ok = false;
  }
  if (cc) api->freeCCtx(cc);
  if (dc) api->freeDCtx(dc);
  return ok;
}

// Cached canonical status per API table (probing costs ~10 ms).
static bool zstd_current_is_canonical() {
  static std::mutex mu;
  static std::map<const ZstdApi*, bool>* verdicts =
      new std::map<const ZstdApi*, bool>();
  const ZstdApi* api = g_zstd.load(std::memory_order_acquire);
  std::lock_guard<std::mutex> lock(mu);
  auto it = verdicts->find(api);
  if (it != verdicts->end()) return it->second;
  bool ok = zstd_api_is_canonical(api);
  (*verdicts)[api] = ok;
  return ok;
}

// Probe-verify a candidate zstd library against the CANONICAL frame hashes
// and swap the dispatch table on exact match.  Returns 0 ok, 1 dlopen
// failure, 2 missing symbols, 3 not canonical (frame/roundtrip mismatch).
// path == NULL or "system" restores the linked library (allowed even
// though the linked build may be non-canonical -- an explicit operator
// choice; fhe_tpu_zstd_canonical() reports the resulting status).  Call at
// init, before worker threads, though a mid-flight swap is safe too (live
// holders keep their captured API; the dlopen handle is never closed).
static int32_t use_libzstd(const char* path) {
  if (!path || std::strcmp(path, "system") == 0) {
    g_zstd.store(&LINKED_ZSTD, std::memory_order_release);
    return 0;
  }
  // Verified-candidate cache keyed by resolved path: NativeCodec re-runs
  // the probe per construction, and re-dlopening + re-allocating a fresh
  // ZstdApi each time leaked the previous table (dlopen itself refcounts
  // the handle, so reusing the first table is exactly equivalent).  The
  // lock is held across the probe so concurrent first-probes of the same
  // path cannot double-allocate.
  static std::mutex cache_mu;
  static std::map<std::string, const ZstdApi*>* cache =
      new std::map<std::string, const ZstdApi*>();
  char rbuf[4096];
  std::string key = realpath(path, rbuf) ? rbuf : path;
  std::lock_guard<std::mutex> cache_lock(cache_mu);
  {
    auto it = cache->find(key);
    if (it != cache->end()) {
      g_zstd.store(it->second, std::memory_order_release);
      return 0;
    }
  }
  // Sanitizer runtimes make RTLD_DEEPBIND dlopen FATAL
  // (google/sanitizers#611), and without DEEPBIND the candidate's
  // internal cross-calls could silently bind to the global-scope build.
  // The swap is a perf/canonicality optimization, so under sanitizers
  // refuse the probe (rc 1) and stay on the linked build.
  if (dlsym(RTLD_DEFAULT, "__asan_region_is_poisoned") ||
      dlsym(RTLD_DEFAULT, "__tsan_init") ||
      dlsym(RTLD_DEFAULT, "__msan_init"))
    return 1;
  // DEEPBIND: zstd's internal cross-calls to its own EXPORTED functions go
  // through the PLT; without deepbind those bind to whatever libzstd sits
  // in the process's global scope (the slow system build, dragged in
  // RTLD_GLOBAL by unrelated wheels), silently re-routing the candidate's
  // hot loops — measured as the "fast" library running at system speed.
  void* h = dlopen(path, RTLD_NOW | RTLD_LOCAL | RTLD_DEEPBIND);
  if (!h) return 1;
  auto cand = std::make_unique<ZstdApi>();
  cand->createCCtx = (ZSTD_CCtx * (*)(void)) dlsym(h, "ZSTD_createCCtx");
  cand->freeCCtx = (size_t(*)(ZSTD_CCtx*))dlsym(h, "ZSTD_freeCCtx");
  cand->compressCCtx = (size_t(*)(ZSTD_CCtx*, void*, size_t, const void*,
                                  size_t, int))dlsym(h, "ZSTD_compressCCtx");
  cand->createDCtx = (ZSTD_DCtx * (*)(void)) dlsym(h, "ZSTD_createDCtx");
  cand->freeDCtx = (size_t(*)(ZSTD_DCtx*))dlsym(h, "ZSTD_freeDCtx");
  cand->decompressDCtx =
      (size_t(*)(ZSTD_DCtx*, void*, size_t, const void*, size_t))dlsym(
          h, "ZSTD_decompressDCtx");
  cand->getFrameContentSize = (unsigned long long (*)(const void*, size_t))
      dlsym(h, "ZSTD_getFrameContentSize");
  cand->isError = (unsigned (*)(size_t))dlsym(h, "ZSTD_isError");
  cand->compressBound = (size_t(*)(size_t))dlsym(h, "ZSTD_compressBound");
  if (!cand->createCCtx || !cand->freeCCtx || !cand->compressCCtx ||
      !cand->createDCtx || !cand->freeDCtx || !cand->decompressDCtx ||
      !cand->getFrameContentSize || !cand->isError || !cand->compressBound) {
    dlclose(h);
    return 2;
  }
  if (!zstd_api_is_canonical(cand.get())) {
    dlclose(h);
    return 3;
  }
  const ZstdApi* api = cand.release();
  (*cache)[key] = api;  // reused by later probes of the same path
  g_zstd.store(api, std::memory_order_release);  // h stays open
  return 0;
}

// DynArray = nested 16-byte header (compr none) | count u64 | count * u64 LE.
static void pack_dynarray(Writer& w, const u64* vals, size_t count) {
  size_t inner = 8 + 8 * count;
  pack_header(w, HEADER_SIZE + inner, COMPR_NONE);
  w.wr_u64(count);
  w.raw((const u8*)vals, 8 * count);
}

// returns new offset; appends values to *out
static size_t unpack_dynarray(const u8* d, size_t len, size_t off,
                              std::vector<u64>* out) {
  u64 size;
  int compr;
  unpack_header(d, len, off, &size, &compr);
  if (compr != COMPR_NONE) enc_err();  // compressed DynArray unsupported
  if (len - off < HEADER_SIZE + 8) enc_err();
  u64 count;
  std::memcpy(&count, d + off + HEADER_SIZE, 8);
  size_t start = off + HEADER_SIZE + 8;
  if (count > (len - start) / 8) enc_err();  // "DynArray truncated"
  size_t end = start + 8 * (size_t)count;
  out->resize((size_t)count);
  if (count)  // count==0: vector data() may be null (zero-len memcpy is UB)
    std::memcpy(out->data(), d + start, 8 * (size_t)count);
  return end;
}

// seal.compute_parms_id: BLAKE2b-256 over LE u64 [scheme=1, n, *moduli, t].
static std::array<u8, 32> compute_parms_id(u64 n, const std::vector<u64>& ms,
                                           u64 t) {
  std::vector<u64> words;
  words.push_back(1);  // scheme_id bfv
  words.push_back(n);
  for (u64 m : ms) words.push_back(m);
  words.push_back(t);
  std::array<u8, 32> id;
  b2b::hash32((const u8*)words.data(), words.size() * 8, id.data());
  return id;
}

// SealCiphertextBlob (seal.py:136-182): parms_id | is_ntt u8 | size u64 |
// n u64 | k u64 | scale f64 | correction u64 | DynArray.
struct CtBlob {
  std::array<u8, 32> parms_id;
  bool is_ntt = false;
  u64 size = 0, n = 0, k = 0;
  double scale = 1.0;
  u64 corr = 1;
  std::vector<u64> data;  // (size, k, n) flattened

  void members(Writer& w) const {
    w.raw(parms_id.data(), 32);
    w.wr_u8(is_ntt ? 1 : 0);
    w.wr_u64(size);
    w.wr_u64(n);
    w.wr_u64(k);
    w.wr_f64(scale);
    w.wr_u64(corr);
    pack_dynarray(w, data.data(), data.size());
  }
  // returns new offset
  static size_t parse_members(const u8* d, size_t len, size_t off, CtBlob* b) {
    if (len - off < 32 + 1 + 3 * 8 + 8 + 8) enc_err();
    std::memcpy(b->parms_id.data(), d + off, 32);
    b->is_ntt = d[off + 32] != 0;
    std::memcpy(&b->size, d + off + 33, 8);
    std::memcpy(&b->n, d + off + 41, 8);
    std::memcpy(&b->k, d + off + 49, 8);
    std::memcpy(&b->scale, d + off + 57, 8);
    std::memcpy(&b->corr, d + off + 65, 8);
    size_t end = unpack_dynarray(d, len, off + 73, &b->data);
    // overflow-safe count check (size/k/n are untrusted u64s)
    u128 want = (u128)b->size * b->k * b->n;
    if (want != b->data.size()) enc_err();
    return end;
  }
  std::vector<u8> to_stream(bool compress = true) const {
    Writer w;
    members(w);
    return wrap_stream(w.out, compress);
  }
  static CtBlob from_stream(const u8* d, size_t len) {
    std::vector<u8> payload = unwrap_stream(d, len);
    CtBlob b;
    size_t end = parse_members(payload.data(), payload.size(), 0, &b);
    if (end != payload.size()) enc_err();  // trailing bytes
    return b;
  }
};

// SealPlaintextBlob (seal.py:185-218): parms_id | coeff_count u64 | scale f64
// | DynArray.  The SecretKey wire form.
struct PtBlob {
  std::array<u8, 32> parms_id;
  double scale = 1.0;
  std::vector<u64> data;

  static PtBlob from_stream(const u8* d, size_t len) {
    std::vector<u8> payload = unwrap_stream(d, len);
    const u8* p = payload.data();
    size_t plen = payload.size();
    if (plen < 32 + 16) enc_err();
    PtBlob b;
    std::memcpy(b.parms_id.data(), p, 32);
    u64 coeff_count;
    std::memcpy(&coeff_count, p + 32, 8);
    std::memcpy(&b.scale, p + 40, 8);
    size_t end = unpack_dynarray(p, plen, 48, &b.data);
    if (b.data.size() != coeff_count) enc_err();
    if (end != plen) enc_err();
    return b;
  }
};

// SealKSwitchKeysBlob (seal.py:221-272): parms_id | num_vectors u64 |
// per vector: len u64 | len * (16-byte none-compr header + CtBlob members).
struct KSwitchBlob {
  std::array<u8, 32> parms_id;
  std::vector<std::vector<CtBlob>> keys;

  static KSwitchBlob from_stream(const u8* d, size_t len) {
    std::vector<u8> payload = unwrap_stream(d, len);
    const u8* p = payload.data();
    size_t plen = payload.size(), off = 0;
    if (plen < 40) enc_err();
    KSwitchBlob b;
    std::memcpy(b.parms_id.data(), p, 32);
    u64 nvec;
    std::memcpy(&nvec, p + 32, 8);
    off = 40;
    // No count caps (Python seal.py:247-253 has none; caps here would
    // split error-code consensus).  Every iteration consumes bytes, so a
    // huge wire count just hits the truncation checks below.
    for (u64 v = 0; v < nvec; ++v) {
      if (plen - off < 8) enc_err();
      u64 cnt;
      std::memcpy(&cnt, p + off, 8);
      off += 8;
      std::vector<CtBlob> vec;
      for (u64 i = 0; i < cnt; ++i) {
        u64 sz;
        int compr;
        unpack_header(p, plen, off, &sz, &compr);
        if (compr != COMPR_NONE) enc_err();  // nested compressed unsupported
        CtBlob ct;
        off = CtBlob::parse_members(p, plen, off + HEADER_SIZE, &ct);
        vec.push_back(std::move(ct));
      }
      b.keys.push_back(std::move(vec));
    }
    if (off != plen) enc_err();
    return b;
  }
};

// ---------------------------------------------------------------------------
// sunscreen-level containers (serialization/keyio.py)
// ---------------------------------------------------------------------------
struct Ciphertext {
  Params params;
  u64 size = 0;
  std::vector<u64> data;  // (size, k_ct, n)
};

struct SecretKey {
  Params params;
  std::vector<u64> s_ntt;  // (k_key, n) NTT form
};

struct PublicKey {
  Params params;
  std::vector<u64> data;  // (2, k_key, n) NTT form
  bool has_relin = false;
  Params rk_params;
  std::vector<u64> rk;  // (k_ct, 2, k_key, n)
};

static void check_parms_id(const std::array<u8, 32>& got, const Params& p,
                           const std::vector<u64>& moduli) {
  if (got != compute_parms_id(p.n, moduli, p.t)) enc_err();
}

// keyio._check_residue_range: out-of-range words are not valid wire data --
// golden vs accelerated arithmetic only agree on canonical inputs.
// data viewed as (outer, k, n); limb j checked against moduli[j].
static void check_residue_range(const std::vector<u64>& data, size_t k, u64 n,
                                const std::vector<u64>& moduli) {
  size_t outer = data.size() / (k * n);
  for (size_t o = 0; o < outer; ++o)
    for (size_t j = 0; j < k; ++j) {
      const u64 m = moduli[j];
      const u64* p = data.data() + (o * k + j) * n;
      for (u64 i = 0; i < n; ++i)
        if (p[i] >= m) enc_err();
    }
}

// keyio.load_public_key: bincode { Params, Vec<u8> SEAL-pk, Option<galois>
// (skipped), Option<relin> { Params, Vec<u8> SEAL-KSwitchKeys } }.
static PublicKey load_public_key(const u8* d, size_t len) {
  Reader r(d, len);
  PublicKey pk;
  pk.params = read_params(r);
  View pk_stream = r.byte_vec();
  CtBlob blob = CtBlob::from_stream(pk_stream.p, pk_stream.len);
  if (!blob.is_ntt || blob.size != 2) enc_err();
  if (blob.k != pk.params.k_key() || blob.n != pk.params.n) enc_err();
  check_parms_id(blob.parms_id, pk.params, pk.params.coeff);
  check_residue_range(blob.data, blob.k, blob.n, pk.params.coeff);
  pk.data = std::move(blob.data);

  if (r.option()) {
    // galois keys: the reference's keygen strips them (fhe.rs:34-44) but its
    // deserializer accepts them; skip the WithContext { Params, Vec<u8> }.
    read_params(r);
    r.byte_vec();
  }
  if (r.option()) {
    pk.rk_params = read_params(r);
    View ks_stream = r.byte_vec();
    KSwitchBlob ks = KSwitchBlob::from_stream(ks_stream.p, ks_stream.len);
    if (ks.keys.size() != 1) enc_err();  // exactly one vector
    const std::vector<CtBlob>& vec = ks.keys[0];
    size_t k_ct = pk.rk_params.k_ct(), kk = pk.rk_params.k_key();
    u64 n = pk.rk_params.n;
    if (vec.size() != k_ct) enc_err();  // relin decomposition count mismatch
    check_parms_id(ks.parms_id, pk.rk_params, pk.rk_params.coeff);
    pk.rk.reserve(k_ct * 2 * kk * n);
    for (const CtBlob& c : vec) {
      // uniform (2, k_key, n) members -- rejected at the boundary so the
      // engines never index a mis-shaped key buffer (keyio.py boundary
      // checks; golden would raise on the stack/shape mismatch -> but the
      // wire-format contract here is "reject, code 3").
      if (c.size != 2 || c.k != kk || c.n != n) enc_err();
      check_residue_range(c.data, kk, n, pk.rk_params.coeff);
      pk.rk.insert(pk.rk.end(), c.data.begin(), c.data.end());
    }
    pk.has_relin = true;
  }
  r.expect_end();
  return pk;
}

// keyio.load_private_key: bincode { Params, Vec<u8> SEAL-Plaintext }.
static SecretKey load_private_key(const u8* d, size_t len) {
  Reader r(d, len);
  SecretKey sk;
  sk.params = read_params(r);
  View stream = r.byte_vec();
  PtBlob blob = PtBlob::from_stream(stream.p, stream.len);
  r.expect_end();
  size_t kk = sk.params.k_key();
  if (blob.data.size() != kk * sk.params.n) enc_err();
  check_parms_id(blob.parms_id, sk.params, sk.params.coeff);
  check_residue_range(blob.data, kk, sk.params.n, sk.params.coeff);
  sk.s_ntt = std::move(blob.data);
  return sk;
}

// keyio.load_ciphertext: bincode { Params, u64 count=1, Vec<u8> SEAL-ct }.
static Ciphertext load_ciphertext(const u8* d, size_t len) {
  Reader r(d, len);
  Ciphertext ct;
  ct.params = read_params(r);
  if (r.rd_u64() != 1) enc_err();  // multi-blob ciphertexts unsupported
  View stream = r.byte_vec();
  CtBlob blob = CtBlob::from_stream(stream.p, stream.len);
  r.expect_end();
  std::vector<u64> ct_mods = ct.params.ct_moduli();
  if (blob.n != ct.params.n || blob.k != ct_mods.size()) enc_err();
  if (blob.is_ntt) enc_err();  // BFV ciphertexts are coefficient-form
  check_parms_id(blob.parms_id, ct.params, ct_mods);
  check_residue_range(blob.data, blob.k, blob.n, ct_mods);
  ct.size = blob.size;
  ct.data = std::move(blob.data);
  return ct;
}

// keyio.save_ciphertext (the byte form every op emits).
static std::vector<u8> save_ciphertext(const Params& params, u64 size,
                                       const std::vector<u64>& data) {
  Writer w;
  write_params(w, params);
  w.wr_u64(1);
  CtBlob blob;
  blob.parms_id = compute_parms_id(params.n, params.ct_moduli(), params.t);
  blob.is_ntt = false;
  blob.size = size;
  blob.n = params.n;
  blob.k = params.k_ct();
  blob.data = data;
  w.byte_vec(blob.to_stream());
  return std::move(w.out);
}

// ---------------------------------------------------------------------------
// BEHZ auxiliary base derivation (params.py:27-156).  Must agree with the
// Python derivation EXACTLY: the aux base is part of the canonical
// ciphertext arithmetic, so every validator derives the identical primes.
// ---------------------------------------------------------------------------

static u64 mulmod_u64(u64 a, u64 b, u64 m) { return (u64)((u128)a * b % m); }

static u64 powmod_u64(u64 base, u64 exp, u64 m) {
  u64 acc = 1 % m, b = base % m;
  while (exp) {
    if (exp & 1) acc = mulmod_u64(acc, b, m);
    b = mulmod_u64(b, b, m);
    exp >>= 1;
  }
  return acc;
}

// params._is_prime: deterministic Miller-Rabin with the same base set.
static bool is_prime(u64 x) {
  if (x < 2) return false;
  static const u64 SMALL[] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37};
  for (u64 p : SMALL)
    if (x % p == 0) return x == p;
  u64 d = x - 1;
  int s = 0;
  while (d % 2 == 0) {
    d /= 2;
    ++s;
  }
  for (u64 a : SMALL) {
    u64 v = powmod_u64(a, d, x);
    if (v == 1 || v == x - 1) continue;
    bool composite = true;
    for (int i = 0; i < s - 1; ++i) {
      v = mulmod_u64(v, v, x);
      if (v == x - 1) {
        composite = false;
        break;
      }
    }
    if (composite) return false;
  }
  return true;
}

// params.ntt_friendly_primes: scan downward from `below` in steps of 2n.
static std::vector<u64> ntt_friendly_primes(u64 n, size_t count, u64 below,
                                            const std::vector<u64>& exclude) {
  u64 step = 2 * n;
  u64 p = (below - 1) - ((below - 1) % step) + 1;
  std::vector<u64> out;
  while (out.size() < count) {
    if (p < (1ULL << 20)) throw GenericErr{};  // ran out of primes
    bool excluded = false;
    for (u64 e : exclude) excluded |= (e == p);
    if (!excluded && is_prime(p)) out.push_back(p);
    p -= step;
  }
  return out;
}

// params._behz_base: (B, m_sk) sized so the BEHZ bounds hold with headroom.
static void derive_behz_base(const Params& params, std::vector<u64>* B,
                             u64* m_sk) {
  std::vector<u64> ct = params.ct_moduli();
  size_t k = ct.size();
  BigU q = BigU::from_u64(1);
  for (u64 m : ct) q.mul_u64(m);
  BigU c_max = q;
  c_max.mul_u64((u64)(k + 2));
  BigU tensor_max = c_max.mul(c_max);
  tensor_max.mul_u64(2 * params.n);
  // floor_max = tensor_max * t // q + (k+1)*q
  BigU floor_max = tensor_max;
  floor_max.mul_u64(params.t);
  floor_max = floor_max.divmod(q, nullptr);
  BigU kq = q;
  kq.mul_u64((u64)(k + 1));
  floor_max.add(kq);
  BigU two_tensor = tensor_max;
  two_tensor.mul_u64(2);
  BigU two_floor = floor_max;
  two_floor.mul_u64(2);

  size_t count = k;
  for (;;) {
    std::vector<u64> primes =
        ntt_friendly_primes(params.n, count + 1, 1ULL << 37, params.coeff);
    std::vector<u64> base(primes.begin(), primes.begin() + count);
    u64 msk = primes[count];
    BigU prod_b = BigU::from_u64(1);
    for (u64 b : base) prod_b.mul_u64(b);
    BigU lhs1 = q.mul(prod_b);
    lhs1.mul_u64(msk);
    BigU lhs2 = prod_b;
    lhs2.mul_u64(msk);
    if (lhs1.cmp(two_tensor) > 0 && lhs2.cmp(two_floor) > 0) {
      *B = base;
      *m_sk = msk;
      return;
    }
    ++count;
  }
}

// ---------------------------------------------------------------------------
// Plaintext type encodings (encoding.py).  Scalars cross the wire big-endian
// (pack.rs:47-104); polynomials encode binary digits with negacyclic wrap
// for Fractional<64>.
// ---------------------------------------------------------------------------
enum PlainTypeTag { T_U256 = 0, T_U64 = 1, T_I64 = 2, T_FRAC64 = 3 };

struct Scalar {
  int tag;
  std::array<u8, 32> u256be;  // T_U256: big-endian magnitude
  u64 u64v = 0;               // T_U64
  i64 i64v = 0;               // T_I64
  double f = 0.0;             // T_FRAC64
};

static size_t scalar_width(int tag) { return tag == T_U256 ? 32 : 8; }

// pack.py scalar codecs: wrong byte width -> invalid encoding (3).
static Scalar scalar_deserialize(int tag, const u8* d, size_t len) {
  Scalar s;
  s.tag = tag;
  if (len != scalar_width(tag)) enc_err();
  switch (tag) {
    case T_U256:
      std::memcpy(s.u256be.data(), d, 32);
      break;
    case T_U64:
      for (int i = 0; i < 8; ++i) s.u64v = (s.u64v << 8) | d[i];
      break;
    case T_I64: {
      u64 v = 0;
      for (int i = 0; i < 8; ++i) v = (v << 8) | d[i];
      std::memcpy(&s.i64v, &v, 8);
      break;
    }
    case T_FRAC64: {
      u64 bits = 0;
      for (int i = 0; i < 8; ++i) bits = (bits << 8) | d[i];
      std::memcpy(&s.f, &bits, 8);
      break;
    }
  }
  return s;
}

static std::vector<u8> scalar_serialize(const Scalar& s) {
  std::vector<u8> out;
  switch (s.tag) {
    case T_U256:
      out.assign(s.u256be.begin(), s.u256be.end());
      break;
    case T_U64:
      for (int i = 7; i >= 0; --i) out.push_back((u8)(s.u64v >> (8 * i)));
      break;
    case T_I64: {
      u64 v;
      std::memcpy(&v, &s.i64v, 8);
      for (int i = 7; i >= 0; --i) out.push_back((u8)(v >> (8 * i)));
      break;
    }
    case T_FRAC64: {
      u64 bits;
      std::memcpy(&bits, &s.f, 8);
      for (int i = 7; i >= 0; --i) out.push_back((u8)(bits >> (8 * i)));
      break;
    }
  }
  return out;
}

// encoding.encode_unsigned: binary digit i of v at coefficient i.  Python
// writes out[i] for every i < bitlen(v) and hits IndexError when the value
// needs more digits than the ring has (possible with operator-supplied
// small-n keys); GenericErr maps to the same codes at the catch sites
// (binary op -> 7, encrypt -> 6).  Without the check this wrote past the
// n-element vector (heap corruption from untrusted calldata).
static void encode_bits_u64(u64 v, std::vector<u64>* out) {
  if (v) {
    u64 bl = 64 - (u64)__builtin_clzll(v);
    if (bl > out->size()) throw GenericErr{};  // encoding.py:64 IndexError
  }
  for (int i = 0; v; ++i, v >>= 1) (*out)[i] = v & 1;
}

static std::vector<u64> encode_u256(const std::array<u8, 32>& be, u64 n) {
  std::vector<u64> out(n, 0);
  // bitlen of the 256-bit value; Python fails iff bitlen > n
  int top = -1;
  for (int bit = 255; bit >= 0; --bit) {
    int byte_idx = 31 - bit / 8;  // big-endian
    if ((be[byte_idx] >> (bit % 8)) & 1) { top = bit; break; }
  }
  if (top >= 0 && (u64)(top + 1) > n) throw GenericErr{};  // IndexError -> 7/6
  for (int bit = 0; bit <= top; ++bit) {
    int byte_idx = 31 - bit / 8;
    if ((be[byte_idx] >> (bit % 8)) & 1) out[bit] = 1;
  }
  return out;
}

static std::vector<u64> encode_u64v(u64 v, u64 n) {
  std::vector<u64> out(n, 0);
  encode_bits_u64(v, &out);
  return out;
}

// encoding.encode_signed: negative values negate every nonzero coeff mod t.
static std::vector<u64> encode_i64v(i64 v, u64 n, u64 t) {
  u64 mag = v < 0 ? (u64)(-(v + 1)) + 1 : (u64)v;  // INT64_MIN-safe
  std::vector<u64> out(n, 0);
  encode_bits_u64(mag, &out);
  if (v < 0)
    for (u64 i = 0; i < n; ++i)
      if (out[i]) out[i] = t - out[i];
  return out;
}

static const unsigned FRAC_INT_BITS = 64;

// encoding.encode_frac64: integer bit i at coeff i; fractional bit 2^-j at
// coeff n-j negated (x^n = -1).  NaN/inf -> GenericErr (Python: ValueError
// from Fraction(), i.e. NOT an FheError -- the catch site picks 7 or 6).
// Integer part >= 2^64 -> Overflow (4).
static std::vector<u64> encode_frac64v(double v, u64 n, u64 t) {
  if (!std::isfinite(v)) throw GenericErr{};
  std::vector<u64> out(n, 0);
  if (v == 0.0) return out;
  bool neg = v < 0;
  int exp;
  double m = std::frexp(std::fabs(v), &exp);
  u64 M = (u64)std::ldexp(m, 53);  // v = +-M * 2^(exp-53), M < 2^53
  int e2 = exp - 53;
  // signed: n < 64 (operator-supplied keys) means the ring has NO
  // fractional coefficients at all — the old unsigned n-64 underflowed to
  // ~2^64, skipped the bound check and indexed out[n-j] out of bounds.
  // Python's `while frac_part and j <= max_frac` with a negative max_frac
  // never runs and any fractional bit raises overflow (encoding.py:116-124).
  i64 max_frac = (i64)n - (i64)FRAC_INT_BITS;
  if (e2 >= 0) {
    // pure integer: need bitlen(M) + e2 <= 64
    int bl = 64 - __builtin_clzll(M);
    if ((u64)(bl + e2) > FRAC_INT_BITS) ovf_err();
    encode_bits_u64(e2 >= 64 ? 0 : (M << e2), &out);  // bl+e2<=64 => safe
  } else {
    unsigned sh = (unsigned)(-e2);  // <= 1074
    u64 int_part = sh >= 64 ? 0 : (M >> sh);
    int bl = M ? 64 - __builtin_clzll(M) : 0;
    if (bl > (int)sh && (u64)(bl - (int)sh) > FRAC_INT_BITS) ovf_err();
    encode_bits_u64(int_part, &out);
    // fractional bit j (weight 2^-j) = bit (sh - j) of M, j = 1..sh
    for (unsigned j = 1; j <= sh; ++j) {
      unsigned bitpos = sh - j;
      if (bitpos < 64 && ((M >> bitpos) & 1)) {
        if ((i64)j > max_frac) ovf_err();  // more precision than ring has
        out[n - j] = t - 1;  // j <= n-64 => index >= 64, in bounds
      }
    }
  }
  if (neg)
    for (u64 i = 0; i < n; ++i)
      if (out[i]) out[i] = t - out[i];
  return out;
}

// encoding._compose over centered residues: signed big value as (neg, mag).
struct SBig {
  bool neg = false;
  BigU mag;
};

// coeffs[i] in [0, t) canonical; centered = c - t*(c > t/2) (strict >).
static SBig compose_centered(const u64* coeffs, u64 count, u64 t,
                             size_t bit0 = 0) {
  BigU pos, negacc;
  const u64 half = t / 2;
  for (u64 i = 0; i < count; ++i) {
    u64 c = coeffs[i];
    if (c == 0) continue;
    if (c > half)
      negacc.add_shifted(t - c, bit0 + i);
    else
      pos.add_shifted(c, bit0 + i);
  }
  SBig r;
  if (pos.cmp(negacc) >= 0) {
    pos.sub(negacc);
    r.mag = std::move(pos);
  } else {
    negacc.sub(pos);
    r.mag = std::move(negacc);
    r.neg = true;
  }
  return r;
}

// Correctly-rounded (nearest-even) conversion of +-mag / 2^k to double,
// including subnormals -- matches CPython's float(Fraction) exactly
// (int.__truediv__'s correctly-rounded division).  Overflow (rounded
// magnitude >= 2^1024) -> GenericErr, the analog of Python's OverflowError.
static double ratio_to_double(bool neg, const BigU& mag, long k) {
  if (mag.zero()) return 0.0;
  long L = (long)mag.bitlen();
  long e = L - 1 - k;            // value in [2^e, 2^(e+1))
  long u = e - 52;               // ulp exponent
  if (u < -1074) u = -1074;      // subnormal grid
  long sh = k + u;               // round(mag / 2^sh)
  u64 q;
  if (sh <= 0) {
    // exact left shift; result bits = L - sh <= 53 by choice of u
    q = mag.low_u64() << (unsigned)(-sh);
    // (L <= 64 guaranteed: L - sh <= 53 and sh <= 0 => L <= 53)
  } else {
    bool guard = false, sticky = false;
    q = mag.shr_collect((size_t)sh, &guard, &sticky);
    if (guard && (sticky || (q & 1))) q += 1;
  }
  if (q == 0) return neg ? -0.0 : 0.0;
  double r = std::ldexp((double)q, (int)u);
  if (std::isinf(r)) throw GenericErr{};  // Python OverflowError analog
  return neg ? -r : r;
}

// encoding.decode_* : poly (n,) mod t -> Scalar.  Out-of-range -> Overflow(4)
// (the decrypt-side catch sites then map to 5, app.py:235-238,260-263).
static Scalar decode_plain(int tag, const u64* poly, u64 n, u64 t) {
  Scalar s;
  s.tag = tag;
  if (tag == T_FRAC64) {
    // n < 64: Python's `Fraction(frac, 1 << (n-64))` raises ValueError on
    // the negative shift -> decrypt-side catch -> code 5.  Without this the
    // composes below read 64 coefficients from an n-element poly (OOB).
    if (n < FRAC_INT_BITS) throw GenericErr{};
    long kbits = (long)(n - FRAC_INT_BITS);
    SBig ip = compose_centered(poly, FRAC_INT_BITS, t);
    SBig fr = compose_centered(poly + FRAC_INT_BITS, n - FRAC_INT_BITS, t);
    // val = ip - fr / 2^kbits = (ip * 2^kbits - fr) / 2^kbits
    ip.mag.shl_bits((size_t)kbits);
    SBig num;
    if (ip.neg == fr.neg) {
      // same sign: magnitudes subtract
      if (ip.mag.cmp(fr.mag) >= 0) {
        ip.mag.sub(fr.mag);
        num.mag = std::move(ip.mag);
        num.neg = ip.neg;
      } else {
        fr.mag.sub(ip.mag);
        num.mag = std::move(fr.mag);
        num.neg = !fr.neg;
      }
    } else {
      ip.mag.add(fr.mag);
      num.mag = std::move(ip.mag);
      num.neg = ip.neg;
    }
    s.f = ratio_to_double(num.neg, num.mag, kbits);
    return s;
  }
  SBig v = compose_centered(poly, n, t);
  if (tag == T_I64) {
    // -(2^63) <= val < 2^63 (encoding.py:87-91)
    if (v.mag.w.size() > 1) ovf_err();
    u64 m = v.mag.low_u64();
    if (!v.neg) {
      if (m >= (1ULL << 63)) ovf_err();
      s.i64v = (i64)m;
    } else {
      if (m > (1ULL << 63)) ovf_err();
      s.i64v = m == (1ULL << 63) ? INT64_MIN : -(i64)m;
    }
    return s;
  }
  // unsigned: 0 <= val < 2^bits
  if (v.neg && !v.mag.zero()) ovf_err();
  unsigned bits = tag == T_U256 ? 256 : 64;
  if (v.mag.bitlen() > bits) ovf_err();
  if (tag == T_U64) {
    s.u64v = v.mag.low_u64();
  } else {
    s.u256be.fill(0);
    for (size_t i = 0; i < v.mag.w.size() && i < 4; ++i) {
      u64 w = v.mag.w[i];
      for (int b = 0; b < 8; ++b)
        s.u256be[31 - 8 * i - b] = (u8)(w >> (8 * b));
    }
  }
  return s;
}

// encode a decoded-or-wire Scalar into a plaintext polynomial
static std::vector<u64> encode_plain(const Scalar& s, u64 n, u64 t) {
  switch (s.tag) {
    case T_U256:
      return encode_u256(s.u256be, n);
    case T_U64:
      return encode_u64v(s.u64v, n);
    case T_I64:
      return encode_i64v(s.i64v, n, t);
    default:
      return encode_frac64v(s.f, n, t);
  }
}

// ---------------------------------------------------------------------------
// Calldata framing (pack.py / pack.rs): u32 BE offsets.
// ---------------------------------------------------------------------------
static u32 be32(const u8* p) {
  return ((u32)p[0] << 24) | ((u32)p[1] << 16) | ((u32)p[2] << 8) | p[3];
}

// pack.rs:153-175 -- [u32 off1][a][b]
static void unpack_two_arguments(const u8* d, size_t len, View* a, View* b) {
  if (len < 4) eof_err();
  u32 off1 = be32(d);
  if (off1 < 4 || off1 > len) eof_err();
  *a = View{d + 4, off1 - 4};
  *b = View{d + off1, len - off1};
}

// pack.rs:238-266 -- [u32 off1][u32 off2][public_key][a][b]
static void unpack_binary_operation(const u8* d, size_t len, View* pk,
                                    View* a, View* b) {
  if (len < 8) eof_err();
  u32 off1 = be32(d), off2 = be32(d + 4);
  if (!(8 <= off1 && off1 <= off2 && off2 <= len)) eof_err();
  *pk = View{d + 8, off1 - 8};
  *a = View{d + off1, off2 - off1};
  *b = View{d + off2, len - off2};
}

// ---------------------------------------------------------------------------
// The application singleton (app.py FheApp + testnet.py one.FHE):
// testnet-one params, network keypair, native engine context, pk parse cache.
// ---------------------------------------------------------------------------

// fhe.rs:604-609 -- the fixed 512-bit private constant mixed into every
// threshold-encrypt seed derivation (protocol constant, app.py:33-38).
static const u8 ENCRYPT_PRIVATE_CONSTANT[64] = {
    15,  17,  225, 5,   30,  1,   237, 218, 130, 19,  37,  95,  222,
    218, 244, 172, 214, 175, 175, 110, 173, 103, 172, 60,  43,  76,
    40,  150, 215, 96,  23,  78,  22,  39,  30,  177, 107, 130, 124,
    109, 27,  96,  206, 125, 104, 241, 10,  40,  88,  238, 117, 118,
    79,  113, 213, 110, 148, 179, 53,  19,  227, 154, 151, 122};

// sampling.py domain tags + CBD parameter (canonical format constants).
static const u64 DOMAIN_TERNARY = 0x7465726E;  // b"tern"
static const u64 DOMAIN_ERROR = 0x6572726F;    // b"erro"
static const u64 CBD_K = 21;

struct App {
  Params params;
  void* he = nullptr;  // host_engine context
  PublicKey net_pk;
  SecretKey net_sk;
  std::vector<u8> pk_bytes;  // verbatim network.pub (public_key_bytes)
  size_t k = 0, kk = 0;
  u64 n = 0, t = 0;

  // LRU over public-key parsing (app.py:43-73): calldata carries ~400 KB of
  // zstd pk on every binary op; serving streams reuse a handful of keys.
  // Keyed by a cheap 64-bit prehash + EXACT byte comparison of the stored
  // input -- collision-proof by memcmp (no crypto hash needed; hashing
  // 400 KB per call would cost more than the cache saves).
  struct CacheEntry {
    std::vector<u8> raw;
    PublicKey pk;
    u8 digest[32];  // BLAKE2b-256 of raw: the host groups requests by it
  };
  // shared_ptr values: a caller's in-flight reference stays valid even if
  // another thread evicts the entry mid-call.
  std::mutex cache_mu;
  std::multimap<u64, std::shared_ptr<CacheEntry>> cache;
  std::list<std::multimap<u64, std::shared_ptr<CacheEntry>>::iterator>
      cache_order;
};

static App* g_app = nullptr;
static std::once_flag g_once;

// Optional in-memory key blobs staged by fhe_tpu_init_keys() before the
// first call; take precedence over the embedded files.  Lets an embedding
// host (e.g. ByteServer) bind the library to ITS key material.
static std::vector<u8> g_staged_pub, g_staged_pri;
static std::mutex g_staged_mu;

static std::vector<u8> read_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) throw GenericErr{};
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<u8> out(sz > 0 ? (size_t)sz : 0);
  size_t got = out.empty() ? 0 : std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (got != out.size()) throw GenericErr{};
  return out;
}

// Locate the embedded network keys: <package>/data/network.{pub,pri}, with
// the package dir found relative to this .so (same dladdr technique as
// c_fhe.cpp).
static std::string data_dir() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&data_dir), &info) == 0 ||
      info.dli_fname == nullptr)
    throw GenericErr{};
  std::string path(info.dli_fname);
  for (int i = 0; i < 2; ++i) {  // strip libc_fhe_native.so, _build/
    size_t slash = path.find_last_of('/');
    if (slash == std::string::npos) throw GenericErr{};
    path.erase(slash);
  }
  return path + "/data";
}

static void init_app() {
  App* app = new App();

  // Key material: the blobs fhe_tpu_init_keys staged (the parameter set
  // is then INFERRED from the key blobs themselves, which embed validated
  // Params), else the embedded testnet-one network keys (the reference's
  // include_bytes! model, fhe.rs:118-119).
  std::vector<u8> staged_pub, staged_pri;
  {
    // snapshot under the lock: a concurrent fhe_tpu_init_keys may be
    // staging blobs while another thread races into first-call init
    std::lock_guard<std::mutex> lock(g_staged_mu);
    staged_pub = g_staged_pub;
    staged_pri = g_staged_pri;
  }
  if (!staged_pub.empty()) {
    app->pk_bytes = std::move(staged_pub);
    app->net_pk = load_public_key(app->pk_bytes.data(), app->pk_bytes.size());
    app->net_sk = load_private_key(staged_pri.data(), staged_pri.size());
    app->params = app->net_pk.params;
  } else {
    std::string dir = data_dir();
    app->pk_bytes = read_file(dir + "/network.pub");
    std::vector<u8> pri = read_file(dir + "/network.pri");
    app->net_pk = load_public_key(app->pk_bytes.data(), app->pk_bytes.size());
    app->net_sk = load_private_key(pri.data(), pri.size());
    // testnet.rs:8-14 byte-for-byte (params.py TESTNET_ONE)
    app->params.n = 4096;
    app->params.coeff = {0xFFFFEE001ULL, 0xFFFFC4001ULL, 0x1FFFFE0001ULL};
    app->params.t = 4096;
  }
  app->n = app->params.n;
  app->t = app->params.t;
  app->k = app->params.k_ct();
  app->kk = app->params.k_key();
  if (app->net_pk.params != app->params || app->net_sk.params != app->params)
    throw FheErr{3};  // network key parameter set mismatch (app.py:111-114)

  std::vector<u64> B;
  u64 m_sk;
  derive_behz_base(app->params, &B, &m_sk);
  std::vector<u64> ct_mods = app->params.ct_moduli();
  app->he = he_ctx_new(app->params.n, app->params.t, ct_mods.data(),
                       ct_mods.size(), app->params.coeff.data(),
                       app->params.coeff.size(), B.data(), B.size(), m_sk,
                       1ULL << 16 /* m_tilde, params.py:154-156 */);
  if (!app->he) throw GenericErr{};

  // Consensus-canonical zstd: if the active build is non-canonical (e.g.
  // the linked system build), warn ONCE -- a validator silently emitting
  // non-canonical frames on low-entropy ciphertexts is a consensus split
  // waiting to be triggered.  (Python hosts swap in a verified build
  // through NativeCodec before this runs; a C host calls
  // fhe_tpu_use_libzstd before its first call.)
  if (!zstd_current_is_canonical())
    std::fprintf(
        stderr,
        "fhe_precompiles_tpu_torch: WARNING: the active zstd build is NOT "
        "the consensus-canonical build (see data/zstd_canonical.json); "
        "emitted ciphertext bytes can differ from canonical validators on "
        "low-entropy payloads.  Pass a canonical libzstd (zstd 1.5.7) to "
        "fhe_tpu_use_libzstd(path) to fix.\n");
  g_app = app;  // publish only on full success
}

static App* app() {
  std::call_once(g_once, [] {
    try {
      init_app();
    } catch (...) {
      // leave g_app null; every call returns 7 (like c_fhe.cpp's g_init_ok)
    }
  });
  return g_app;
}

// FNV-1a over 8-byte chunks: fast prehash; exactness comes from the memcmp.
static u64 prehash(const u8* d, size_t len) {
  u64 h = 0xcbf29ce484222325ULL ^ len;
  size_t i = 0;
  for (; i + 8 <= len; i += 8) {
    u64 w;
    std::memcpy(&w, d + i, 8);
    h = (h ^ w) * 0x100000001b3ULL;
  }
  for (; i < len; ++i) h = (h ^ d[i]) * 0x100000001b3ULL;
  return h;
}

// pk parse with LRU (semantics identical to fresh parsing: exact-byte hit).
static std::shared_ptr<App::CacheEntry> parse_pk_cached(App* a, const u8* d,
                                                        size_t len) {
  u64 key = prehash(d, len);
  {
    std::lock_guard<std::mutex> lock(a->cache_mu);
    auto range = a->cache.equal_range(key);
    for (auto it = range.first; it != range.second; ++it)
      if (it->second->raw.size() == len &&
          std::memcmp(it->second->raw.data(), d, len) == 0)
        return it->second;
  }
  // parse outside the lock: 400 KB of zstd should not serialize all threads
  auto entry = std::make_shared<App::CacheEntry>();
  entry->raw.assign(d, d + len);
  entry->pk = load_public_key(d, len);  // may throw FheErr{3}
  b2b::hash32(d, len, entry->digest);
  std::lock_guard<std::mutex> lock(a->cache_mu);
  // a thread that parsed the same bytes meanwhile inserted first: its
  // entry is the one, so that one key's bytes have one live entry
  auto range = a->cache.equal_range(key);
  for (auto it = range.first; it != range.second; ++it)
    if (it->second->raw.size() == len &&
        std::memcmp(it->second->raw.data(), d, len) == 0)
      return it->second;
  auto ins = a->cache.emplace(key, entry);
  a->cache_order.push_back(ins);
  if (a->cache_order.size() > 16) {
    a->cache.erase(a->cache_order.front());
    a->cache_order.pop_front();
  }
  return entry;
}

// ---------------------------------------------------------------------------
// engine-level helpers
// ---------------------------------------------------------------------------

// NativeEngine.encrypt (native/engine.py:200-223): BLAKE2b-XOF samplers +
// he_encrypt.  seed = 64-byte SHA-512 digest; pk data (2, k_key, n).
static Ciphertext engine_encrypt(App* a, const std::vector<u64>& m_poly,
                                 const PublicKey& pk, const u8 seed[64]) {
  const u64 n = a->n;
  std::vector<i64> u(n), e0(n), e1(n);
  he_sample_ternary(seed, DOMAIN_TERNARY, n, u.data());
  he_sample_cbd_pair(seed, DOMAIN_ERROR, n, CBD_K, e0.data(), e1.data());
  Ciphertext ct;
  ct.params = a->params;
  ct.size = 2;
  ct.data.resize(2 * a->k * n);
  he_encrypt(a->he, m_poly.data(), u.data(), e0.data(), e1.data(),
             pk.data.data(), a->kk, ct.data.data());
  return ct;
}

// decrypt to plaintext poly (mod t); ct params already checked by caller.
static std::vector<u64> engine_decrypt(App* a, const Ciphertext& ct) {
  if (ct.size < 1) throw GenericErr{};  // golden: ct.data[0] -> IndexError
  std::vector<u64> out(a->n);
  he_decrypt(a->he, ct.data.data(), ct.size, a->net_sk.s_ntt.data(),
             out.data());
  return out;
}

// ---------------------------------------------------------------------------
// op families (app.py _binary_op / _encrypt / _reencrypt / _decrypt)
// ---------------------------------------------------------------------------
enum Op { OP_ADD, OP_SUB, OP_MUL };
enum Shape { CC, CP, PC };

// app.py _check_params: objects whose embedded Params differ from the app's
// surface as the stage's failure code, never as wrong-modulus compute.
static void check_params(App* a, const Params& p, int code) {
  if (p != a->params) throw FheErr{code};
}

static std::vector<u8> do_binary(App* a, Op op, Shape shape, int tag,
                                 const u8* input, size_t len) {
  View pk_v, a_v, b_v;
  unpack_binary_operation(input, len, &pk_v, &a_v, &b_v);
  // Parse ALL three calldata segments before any params check: FheApp
  // deserializes pk, a and b eagerly inside unpack_binary_operation
  // (pack.py:195-197) and only then runs _check_params, so a mismatched-
  // params pk combined with a malformed operand must return 3 (parse), not
  // 7 — checking pk params first here split validator consensus.
  auto pk_entry = parse_pk_cached(a, pk_v.p, pk_v.len);
  const PublicKey* pk = &pk_entry->pk;

  Ciphertext ca, cb;
  Scalar sa, sb;
  if (shape == CC || shape == CP)
    ca = load_ciphertext(a_v.p, a_v.len);
  else
    sa = scalar_deserialize(tag, a_v.p, a_v.len);
  if (shape == CC || shape == PC)
    cb = load_ciphertext(b_v.p, b_v.len);
  else
    sb = scalar_deserialize(tag, b_v.p, b_v.len);

  // app.py _binary_op check order: pk, then a, then b (all code 7)
  check_params(a, pk->params, 7);
  if (shape == CC || shape == CP) check_params(a, ca.params, 7);
  if (shape == CC || shape == PC) check_params(a, cb.params, 7);

  const u64 n = a->n;
  const size_t k = a->k;
  Ciphertext out;
  out.params = a->params;
  // everything below mirrors app.py _run_op: FheErr propagates (e.g.
  // Overflow(4) from plaintext encode); any other failure -> 7.
  try {
    if (shape == CC) {
      if (op == OP_ADD || op == OP_SUB) {
        // SEAL Evaluator::add/sub zero-extension semantics for ANY
        // component counts (golden._ext_addsub): shared prefix combines,
        // the larger operand's extras are copied (negated when they come
        // from the subtrahend).  All engines agree byte-for-byte
        // (tests/test_size_semantics.py).
        if (ca.size < 1 || cb.size < 1) throw GenericErr{};
        u64 m = ca.size < cb.size ? ca.size : cb.size;
        u64 big = ca.size < cb.size ? cb.size : ca.size;
        out.size = big;
        out.data.resize(big * k * n);
        (op == OP_ADD ? he_add : he_sub)(a->he, ca.data.data(), cb.data.data(),
                                         m, out.data.data());
        if (ca.size > cb.size) {
          std::memcpy(out.data.data() + m * k * n, ca.data.data() + m * k * n,
                      (big - m) * k * n * sizeof(u64));
        } else if (cb.size > ca.size) {
          if (op == OP_SUB)
            he_neg(a->he, cb.data.data() + m * k * n, big - m,
                   out.data.data() + m * k * n);
          else
            std::memcpy(out.data.data() + m * k * n,
                        cb.data.data() + m * k * n,
                        (big - m) * k * n * sizeof(u64));
        }
      } else {
        if (!pk->has_relin)
          throw FheErr{7};  // "public key lacks relinearization keys"
        // NativeEngine.multiply/relinearize preconditions (engine.py):
        // size-2 operands; relin key shaped (k, 2, k_key, n) for our params.
        if (ca.size != 2 || cb.size != 2) throw GenericErr{};
        if (pk->rk_params != a->params) throw GenericErr{};
        std::vector<u64> tmp(3 * k * n);
        he_multiply(a->he, ca.data.data(), cb.data.data(), tmp.data());
        out.size = 2;
        out.data.resize(2 * k * n);
        he_relinearize(a->he, tmp.data(), pk->rk.data(), out.data.data());
      }
    } else {
      // one ciphertext + one plaintext polynomial
      const Ciphertext& c = shape == CP ? ca : cb;
      const Scalar& s = shape == CP ? sb : sa;
      if (c.size < 1) throw GenericErr{};
      std::vector<u64> m = encode_plain(s, n, a->t);  // may throw FheErr{4}
      out.size = c.size;
      out.data.resize(c.size * k * n);
      if (op == OP_MUL) {
        he_mul_plain(a->he, c.data.data(), c.size, m.data(), out.data.data());
      } else {
        // affine modes: 0 add, 1 sub (ct - m), 2 plain_sub (m - ct)
        int mode = op == OP_ADD ? 0 : (shape == CP ? 1 : 2);
        he_plain_affine(a->he, c.data.data(), c.size, m.data(), mode,
                        out.data.data());
      }
    }
  } catch (FheErr&) {
    throw;
  } catch (...) {
    throw FheErr{7};  // app.py:165-166 -> RUNTIME_ERROR
  }
  return save_ciphertext(out.params, out.size, out.data);
}

// app.py _encrypt (fhe.rs:594-618): deterministic encrypt under network key.
static std::vector<u8> do_encrypt(App* a, int tag, const u8* input,
                                  size_t len) {
  View plain_v, pd_v;
  unpack_two_arguments(input, len, &plain_v, &pd_v);
  Scalar plain = scalar_deserialize(tag, plain_v.p, plain_v.len);
  std::vector<u8> plain_ser = scalar_serialize(plain);
  u8 seed[64];
  {
    sha512::Ctx h;
    h.update(pd_v.p, pd_v.len);
    h.update(ENCRYPT_PRIVATE_CONSTANT, 64);
    h.update(plain_ser.data(), plain_ser.size());
    h.final(seed);
  }
  Ciphertext ct;
  try {
    std::vector<u64> m = encode_plain(plain, a->n, a->t);
    ct = engine_encrypt(a, m, a->net_pk, seed);
  } catch (...) {
    throw FheErr{6};  // every encrypt-side failure -> FailedEncryption
  }
  return save_ciphertext(ct.params, ct.size, ct.data);
}

// app.py _reencrypt (fhe.rs:632-678): decrypt under network key, re-encrypt
// deterministically under the caller key; seed binds the full input.
static std::vector<u8> do_reencrypt(App* a, int tag, const u8* input,
                                    size_t len) {
  View pk_v, ct_v, pd_v;
  unpack_binary_operation(input, len, &pk_v, &ct_v, &pd_v);
  auto pk_entry = parse_pk_cached(a, pk_v.p, pk_v.len);
  const PublicKey* pk = &pk_entry->pk;
  Ciphertext ct = load_ciphertext(ct_v.p, ct_v.len);
  check_params(a, ct.params, 5);
  check_params(a, pk->params, 6);
  Scalar value;
  try {
    std::vector<u64> poly = engine_decrypt(a, ct);
    value = decode_plain(tag, poly.data(), a->n, a->t);
  } catch (...) {
    throw FheErr{5};  // every decrypt-side failure -> FailedDecryption
  }
  std::vector<u8> value_ser = scalar_serialize(value);
  u8 seed[64];
  {
    sha512::Ctx h;
    h.update(pd_v.p, pd_v.len);
    h.update(input, len);  // public_data += entire input (fhe.rs:676)
    h.update(value_ser.data(), value_ser.size());
    h.final(seed);
  }
  Ciphertext out;
  try {
    std::vector<u64> m = encode_plain(value, a->n, a->t);
    out = engine_encrypt(a, m, *pk, seed);
  } catch (...) {
    throw FheErr{6};
  }
  return save_ciphertext(out.params, out.size, out.data);
}

// app.py _decrypt (fhe.rs:688-699): output is the scalar's BE bytes, NOT
// bincode.
static std::vector<u8> do_decrypt(App* a, int tag, const u8* input,
                                  size_t len) {
  Ciphertext ct = load_ciphertext(input, len);  // one-argument = bare payload
  check_params(a, ct.params, 5);
  Scalar value;
  try {
    std::vector<u64> poly = engine_decrypt(a, ct);
    value = decode_plain(tag, poly.data(), a->n, a->t);
  } catch (...) {
    throw FheErr{5};
  }
  return scalar_serialize(value);
}

// ---------------------------------------------------------------------------
// name dispatch (PRECOMPILE_NAMES grammar, app.py:344-354)
// ---------------------------------------------------------------------------
static bool parse_type(const std::string& s, int* tag) {
  if (s == "u256") *tag = T_U256;
  else if (s == "u64") *tag = T_U64;
  else if (s == "i64") *tag = T_I64;
  else if (s == "frac64") *tag = T_FRAC64;
  else return false;
  return true;
}

static std::vector<u8> dispatch(App* a, const char* name, const u8* input,
                                size_t len) {
  std::string s(name);
  if (s == "public_key_bytes") return a->pk_bytes;  // fhe.rs:701-703
  size_t us = s.find('_');
  std::string head = s.substr(0, us);
  std::string rest = s.substr(us + 1);
  if (head == "encrypt" || head == "reencrypt" || head == "decrypt") {
    int tag;
    if (!parse_type(rest, &tag)) throw FheErr{3};
    if (head == "encrypt") return do_encrypt(a, tag, input, len);
    if (head == "reencrypt") return do_reencrypt(a, tag, input, len);
    return do_decrypt(a, tag, input, len);
  }
  Op op = head == "add" ? OP_ADD : head == "sub" ? OP_SUB : OP_MUL;
  size_t mid = rest.find('_');
  std::string at = rest.substr(0, mid), bt = rest.substr(mid + 1);
  bool a_ct = at.rfind("cipher", 0) == 0, b_ct = bt.rfind("cipher", 0) == 0;
  int tag;
  if (!parse_type(a_ct ? at.substr(6) : at, &tag)) throw FheErr{3};
  Shape shape = a_ct && b_ct ? CC : (a_ct ? CP : PC);
  return do_binary(a, op, shape, tag, input, len);
}

static int32_t run_precompile(const char* name, const u8* bytes,
                              size_t bytes_length, u8** output,
                              i64* output_length) {
  if (output == nullptr || output_length == nullptr) return 3;
  *output = nullptr;
  *output_length = 0;
  App* a = app();
  if (!a) return 7;  // init failed (c_fhe.cpp g_init_ok contract)
  try {
    std::vector<u8> out = dispatch(a, name, bytes, bytes_length);
    u8* buf = (u8*)std::malloc(out.empty() ? 1 : out.size());
    if (!buf) return 7;
    if (!out.empty()) std::memcpy(buf, out.data(), out.size());
    *output = buf;
    *output_length = (i64)out.size();
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;  // app.py call(): any non-FheError -> RUNTIME_ERROR
  }
}

// ---------------------------------------------------------------------------
// TPU-host batched codec front end (fhe_tpu_* — an extension beyond the
// 49-op reference ABI, exported only by libc_fhe_native.so).
//
// Purpose: a TPU serving host (serve.ByteServer) wants the byte surface —
// calldata in, calldata out, per c_fhe.rs:8-59 — but with the host codec
// work (zstd, bincode/SEAL parsing, plaintext encoding, range checks) in
// C++ worker threads and the FHE compute batched on the device.  These
// entry points split do_binary/do_encrypt/do_decrypt at exactly the
// decode/compute boundary, preserving the same error codes and check
// order, so the server's (code, payload) stays byte-identical to
// FheApp.call / c_fhe_* one call at a time.
// ---------------------------------------------------------------------------

// Opaque pk reference handed to the host: keeps the LRU entry alive (the
// cache may evict underneath) and gives a stable grouping identity.
struct PkHandle {
  std::shared_ptr<App::CacheEntry> e;
};

static bool parse_binary_name(const char* name, Op* op, Shape* shape,
                              int* tag) {
  std::string s(name);
  size_t us = s.find('_');
  if (us == std::string::npos) return false;
  std::string head = s.substr(0, us), rest = s.substr(us + 1);
  if (head == "add") *op = OP_ADD;
  else if (head == "sub") *op = OP_SUB;
  else if (head == "mul") *op = OP_MUL;
  else return false;
  size_t mid = rest.find('_');
  if (mid == std::string::npos) return false;
  std::string at = rest.substr(0, mid), bt = rest.substr(mid + 1);
  bool a_ct = at.rfind("cipher", 0) == 0, b_ct = bt.rfind("cipher", 0) == 0;
  if (!parse_type(a_ct ? at.substr(6) : at, tag)) return false;
  *shape = a_ct && b_ct ? CC : (a_ct ? CP : PC);
  return true;
}

// Decode phase of do_binary: parse + params/relin checks + plaintext
// encoding, NO compute.  On success (returns 0):
//   cc:     ct_out <- a (iff size 2), other_out <- b (iff size 2),
//           ct_size/other_size = sizes
//   cp/pc:  ct_out <- the ciphertext operand (iff size 2), other_out <-
//           the encoded plaintext poly (n,), other_size = 0
//   pk_handle <- owned reference (fhe_tpu_pk_release), grouped by
//   fhe_tpu_pk_digest.  A ciphertext of size != 2 is NOT an error (add/sub of
//   size-3 cts and any-size plain ops are legal): the caller must fall
//   back to the one-shot path for those requests.
static int32_t tpu_unpack_binary(const char* name, const u8* input,
                                 size_t len, u64* ct_out, u64* other_out,
                                 int32_t* shape_out, int32_t* op_out,
                                 u64* ct_size_out, u64* other_size_out,
                                 void** pk_handle) {
  if (!name || !ct_out || !other_out || !shape_out || !op_out ||
      !ct_size_out || !other_size_out || !pk_handle)
    return 3;
  *pk_handle = nullptr;
  App* a = app();
  if (!a) return 7;
  Op op;
  Shape shape;
  int tag;
  if (!parse_binary_name(name, &op, &shape, &tag)) return 3;
  try {
    View pk_v, a_v, b_v;
    unpack_binary_operation(input, len, &pk_v, &a_v, &b_v);
    auto pk_entry = parse_pk_cached(a, pk_v.p, pk_v.len);
    const PublicKey* pk = &pk_entry->pk;
    Ciphertext ca, cb;
    Scalar sa, sb;
    if (shape == CC || shape == CP)
      ca = load_ciphertext(a_v.p, a_v.len);
    else
      sa = scalar_deserialize(tag, a_v.p, a_v.len);
    if (shape == CC || shape == PC)
      cb = load_ciphertext(b_v.p, b_v.len);
    else
      sb = scalar_deserialize(tag, b_v.p, b_v.len);
    // app.py _binary_op check order: pk, a, b — all RUNTIME_ERROR(7)
    check_params(a, pk->params, 7);
    if (shape == CC || shape == CP) check_params(a, ca.params, 7);
    if (shape == CC || shape == PC) check_params(a, cb.params, 7);

    const u64 n = a->n;
    const size_t k = a->k;
    if (shape == CC) {
      if (op == OP_MUL) {
        // _run_op's relin precondition (app.py:150-153) and do_binary's
        // rk shape guard — both RUNTIME_ERROR(7) on the one-shot path
        if (!pk->has_relin) return 7;
        if (pk->rk_params != a->params) return 7;
      }
      *ct_size_out = ca.size;
      *other_size_out = cb.size;
      if (ca.size == 2)
        std::memcpy(ct_out, ca.data.data(), 2 * k * n * sizeof(u64));
      if (cb.size == 2)
        std::memcpy(other_out, cb.data.data(), 2 * k * n * sizeof(u64));
    } else {
      const Ciphertext& c = shape == CP ? ca : cb;
      const Scalar& s = shape == CP ? sb : sa;
      if (c.size < 1) return 7;  // engine precondition (do_binary:1613)
      std::vector<u64> m;
      try {
        m = encode_plain(s, n, a->t);  // may throw FheErr{4}
      } catch (FheErr&) {
        throw;
      } catch (...) {
        return 7;  // app.py _run_op: non-FheError -> RUNTIME_ERROR
      }
      *ct_size_out = c.size;
      *other_size_out = 0;
      if (c.size == 2)
        std::memcpy(ct_out, c.data.data(), 2 * k * n * sizeof(u64));
      std::memcpy(other_out, m.data(), n * sizeof(u64));
    }
    *shape_out = (int32_t)shape;
    *op_out = (int32_t)op;
    *pk_handle = new PkHandle{std::move(pk_entry)};
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;
  }
}

static int32_t tpu_pk_id(void* handle, u64* id) {
  if (!handle || !id) return 3;
  *id = (u64)(uintptr_t)static_cast<PkHandle*>(handle)->e.get();
  return 0;
}

// The BLAKE2b-256 digest of the key's bytes (32 bytes): equal for equal
// bytes, also across an eviction from the cache, which gives the same
// bytes a second entry and id.
static int32_t tpu_pk_digest(void* handle, u8* out) {
  if (!handle || !out) return 3;
  std::memcpy(out, static_cast<PkHandle*>(handle)->e->digest, 32);
  return 0;
}

// Copy the relin key block (k_ct, 2, k_key, n) u64 for the device path;
// errors if the key has none (callers check op==mul first).
static int32_t tpu_pk_relin(void* handle, u64* out) {
  if (!handle || !out) return 3;
  const PublicKey& pk = static_cast<PkHandle*>(handle)->e->pk;
  if (!pk.has_relin) return 7;
  std::memcpy(out, pk.rk.data(), pk.rk.size() * sizeof(u64));
  return 0;
}

static void tpu_pk_release(void* handle) {
  delete static_cast<PkHandle*>(handle);
}

// Encode phase of every op's output: raw (size, k, n) residues -> the
// bincode/SEAL/zstd ciphertext bytes FheApp emits (save_ciphertext).
static int32_t tpu_pack_ciphertext(const u64* data, u64 size, u8** out,
                                   i64* out_len) {
  if (!data || !out || !out_len || size < 1) return 3;
  *out = nullptr;
  *out_len = 0;
  App* a = app();
  if (!a) return 7;
  try {
    std::vector<u64> v(data, data + (size_t)size * a->k * a->n);
    std::vector<u8> bytes = save_ciphertext(a->params, size, v);
    u8* buf = (u8*)std::malloc(bytes.empty() ? 1 : bytes.size());
    if (!buf) return 7;
    if (!bytes.empty()) std::memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    *out_len = (i64)bytes.size();
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;
  }
}

// Decode phase of do_encrypt: parse calldata, derive the deterministic
// SHA-512 seed (fhe.rs:600-611) and encode the plaintext; the device then
// runs the batched seeded encrypt under the network key.
static int32_t tpu_unpack_encrypt(const char* tname, const u8* input,
                                  size_t len, u64* m_out, u8* seed_out) {
  if (!tname || !m_out || !seed_out) return 3;
  App* a = app();
  if (!a) return 7;
  int tag;
  if (!parse_type(tname, &tag)) return 3;
  try {
    View plain_v, pd_v;
    unpack_two_arguments(input, len, &plain_v, &pd_v);
    Scalar plain = scalar_deserialize(tag, plain_v.p, plain_v.len);
    std::vector<u8> plain_ser = scalar_serialize(plain);
    sha512::Ctx h;
    h.update(pd_v.p, pd_v.len);
    h.update(ENCRYPT_PRIVATE_CONSTANT, 64);
    h.update(plain_ser.data(), plain_ser.size());
    h.final(seed_out);
    std::vector<u64> m;
    try {
      m = encode_plain(plain, a->n, a->t);
    } catch (...) {
      return 6;  // every encrypt-side failure -> FailedEncryption
    }
    std::memcpy(m_out, m.data(), a->n * sizeof(u64));
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;
  }
}

// Decode phase of do_decrypt: parse the bare ciphertext payload + the
// params check (5).  size != 2 -> caller falls back (golden handles any
// size; the batched device path is size-2 only).
static int32_t tpu_unpack_decrypt(const u8* input, size_t len, u64* ct_out,
                                  u64* ct_size_out) {
  if (!ct_out || !ct_size_out) return 3;
  App* a = app();
  if (!a) return 7;
  try {
    Ciphertext ct = load_ciphertext(input, len);
    check_params(a, ct.params, 5);
    if (ct.size < 1) return 5;  // engine_decrypt precondition
    *ct_size_out = ct.size;
    if (ct.size == 2)
      std::memcpy(ct_out, ct.data.data(),
                  2 * a->k * a->n * sizeof(u64));
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;
  }
}

// Encode phase of do_decrypt's output: mod-t poly -> big-endian scalar
// bytes; ANY decode failure maps to FailedDecryption(5) (app.py:260-268).
static int32_t tpu_decode_scalar(const char* tname, const u64* poly,
                                 u8** out, i64* out_len) {
  if (!tname || !poly || !out || !out_len) return 3;
  *out = nullptr;
  *out_len = 0;
  App* a = app();
  if (!a) return 7;
  int tag;
  if (!parse_type(tname, &tag)) return 3;
  try {
    Scalar value = decode_plain(tag, poly, a->n, a->t);
    std::vector<u8> bytes = scalar_serialize(value);
    u8* buf = (u8*)std::malloc(bytes.empty() ? 1 : bytes.size());
    if (!buf) return 7;
    std::memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    *out_len = (i64)bytes.size();
    return 0;
  } catch (...) {
    return 5;
  }
}

// Decode phase of do_reencrypt: parse (pk, ciphertext, public_data),
// params checks in app.py _reencrypt order (ct -> 5, pk -> 6).  The
// caller then batch-decrypts under the network key, finishes each item
// with fhe_tpu_reencrypt_finish, and batch-encrypts under the target pk
// (grouped by fhe_tpu_pk_digest).  size != 2 -> route to the one-shot path.
static int32_t tpu_unpack_reencrypt(const u8* input, size_t len,
                                    u64* ct_out, u64* ct_size_out,
                                    void** pk_handle) {
  if (!ct_out || !ct_size_out || !pk_handle) return 3;
  *pk_handle = nullptr;
  App* a = app();
  if (!a) return 7;
  try {
    View pk_v, ct_v, pd_v;
    unpack_binary_operation(input, len, &pk_v, &ct_v, &pd_v);
    auto pk_entry = parse_pk_cached(a, pk_v.p, pk_v.len);
    Ciphertext ct = load_ciphertext(ct_v.p, ct_v.len);
    check_params(a, ct.params, 5);
    check_params(a, pk_entry->pk.params, 6);
    if (ct.size < 1) return 5;  // engine_decrypt precondition
    *ct_size_out = ct.size;
    if (ct.size == 2)
      std::memcpy(ct_out, ct.data.data(), 2 * a->k * a->n * sizeof(u64));
    *pk_handle = new PkHandle{std::move(pk_entry)};
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;
  }
}

// Host half between the two device phases of reencrypt: decode the
// decrypted poly (failures -> 5, app.py:240-243), derive the full-input-
// bound seed (fhe.rs:676: public_data + entire input + value bytes) and
// re-encode the value (failures -> 6).
static int32_t tpu_reencrypt_finish(const char* tname, const u8* input,
                                    size_t len, const u64* poly, u64* m_out,
                                    u8* seed_out) {
  if (!tname || !poly || !m_out || !seed_out) return 3;
  App* a = app();
  if (!a) return 7;
  int tag;
  if (!parse_type(tname, &tag)) return 3;
  try {
    View pk_v, ct_v, pd_v;
    unpack_binary_operation(input, len, &pk_v, &ct_v, &pd_v);
    Scalar value;
    try {
      value = decode_plain(tag, poly, a->n, a->t);
    } catch (...) {
      return 5;
    }
    std::vector<u8> value_ser = scalar_serialize(value);
    sha512::Ctx h;
    h.update(pd_v.p, pd_v.len);
    h.update(input, len);
    h.update(value_ser.data(), value_ser.size());
    h.final(seed_out);
    std::vector<u64> m;
    try {
      m = encode_plain(value, a->n, a->t);
    } catch (...) {
      return 6;
    }
    std::memcpy(m_out, m.data(), a->n * sizeof(u64));
    return 0;
  } catch (FheErr& e) {
    return e.code;
  } catch (...) {
    return 7;
  }
}

// The parsed key's (2, k_key, n) data — the device path encrypts under
// caller-supplied target keys.
static int32_t tpu_pk_data(void* handle, u64* out) {
  if (!handle || !out) return 3;
  const PublicKey& pk = static_cast<PkHandle*>(handle)->e->pk;
  std::memcpy(out, pk.data.data(), pk.data.size() * sizeof(u64));
  return 0;
}

static int32_t tpu_init_keys(const u8* pub, size_t pub_len, const u8* pri,
                             size_t pri_len) {
  if (!pub || !pri || !pub_len || !pri_len) return 3;
  {
    std::lock_guard<std::mutex> lock(g_staged_mu);
    if (g_app == nullptr) {
      g_staged_pub.assign(pub, pub + pub_len);
      g_staged_pri.assign(pri, pri + pri_len);
    }
  }
  App* a = app();
  if (!a) return 7;
  // already initialized (possibly by an earlier caller): succeed only if
  // the public key bytes agree — one process serves one network key set.
  if (a->pk_bytes.size() != pub_len ||
      std::memcmp(a->pk_bytes.data(), pub, pub_len) != 0)
    return 3;
  return 0;
}

static int32_t tpu_params(u64* n, u64* k_ct, u64* k_key, u64* t) {
  if (!n || !k_ct || !k_key || !t) return 3;
  App* a = app();
  if (!a) return 7;
  *n = a->n;
  *k_ct = a->k;
  *k_key = a->kk;
  *t = a->t;
  return 0;
}

}  // namespace fheabi

// ---------------------------------------------------------------------------
// extern-C surface: identical symbol set to c_fhe.cpp / c_fhe.rs:61-141.
// ---------------------------------------------------------------------------
extern "C" {

void fhe_free(const u8* bytes) { std::free(const_cast<u8*>(bytes)); }

const char* fhe_error(int32_t error_code) {
  const char* msg;
  switch (error_code) {  // strings: lib.rs:33-44
    case 1: msg = "Unexpected end of file"; break;
    case 2: msg = "Platform architecture invalid"; break;
    case 3: msg = "Invalid encoding"; break;
    case 4: msg = "Overflow in FHE program"; break;
    case 5: msg = "Invalid decryption"; break;
    case 6: msg = "Invalid encryption"; break;
    case 7: msg = "Base sunscreen error"; break;
    default: msg = "Unknown error"; break;
  }
  size_t len = std::strlen(msg) + 1;
  char* out = static_cast<char*>(std::malloc(len));
  if (out != nullptr) std::memcpy(out, msg, len);
  return out;
}

#define DEFINE_C_PRECOMPILE(name)                                      \
  int32_t c_fhe_##name(const u8* bytes, size_t bytes_length,           \
                       u8** output, i64* output_length) {              \
    return fheabi::run_precompile(#name, bytes, bytes_length, output,  \
                                  output_length);                      \
  }

FHE_PRECOMPILE_LIST(DEFINE_C_PRECOMPILE)

#undef DEFINE_C_PRECOMPILE

// ---- TPU-host batched codec extension (see c_fhe.h; not part of the
// 51-symbol reference surface) ----------------------------------------------

int32_t fhe_tpu_init_keys(const uint8_t* pub, size_t pub_len,
                          const uint8_t* pri, size_t pri_len) {
  return fheabi::tpu_init_keys(pub, pub_len, pri, pri_len);
}

int32_t fhe_tpu_use_libzstd(const char* path) {
  return fheabi::use_libzstd(path);
}

int32_t fhe_tpu_zstd_canonical(void) {
  return fheabi::zstd_current_is_canonical() ? 1 : 0;
}

int32_t fhe_tpu_params(uint64_t* n, uint64_t* k_ct, uint64_t* k_key,
                       uint64_t* t) {
  return fheabi::tpu_params(n, k_ct, k_key, t);
}

int32_t fhe_tpu_unpack_binary(const char* name, const uint8_t* data,
                              size_t data_len, uint64_t* ct, uint64_t* other,
                              int32_t* shape, int32_t* op, uint64_t* ct_size,
                              uint64_t* other_size, void** pk_handle) {
  return fheabi::tpu_unpack_binary(name, data, data_len, ct, other, shape,
                                   op, ct_size, other_size, pk_handle);
}

int32_t fhe_tpu_pk_id(void* pk_handle, uint64_t* id) {
  return fheabi::tpu_pk_id(pk_handle, id);
}

int32_t fhe_tpu_pk_digest(void* pk_handle, uint8_t* digest) {
  return fheabi::tpu_pk_digest(pk_handle, digest);
}

int32_t fhe_tpu_pk_relin(void* pk_handle, uint64_t* rk_out) {
  return fheabi::tpu_pk_relin(pk_handle, rk_out);
}

void fhe_tpu_pk_release(void* pk_handle) { fheabi::tpu_pk_release(pk_handle); }

int32_t fhe_tpu_pack_ciphertext(const uint64_t* data, uint64_t size,
                                uint8_t** out, int64_t* out_len) {
  return fheabi::tpu_pack_ciphertext(data, size, out, out_len);
}

int32_t fhe_tpu_unpack_encrypt(const char* tname, const uint8_t* data,
                               size_t data_len, uint64_t* m,
                               uint8_t* seed64) {
  return fheabi::tpu_unpack_encrypt(tname, data, data_len, m, seed64);
}

int32_t fhe_tpu_unpack_decrypt(const uint8_t* data, size_t data_len,
                               uint64_t* ct, uint64_t* ct_size) {
  return fheabi::tpu_unpack_decrypt(data, data_len, ct, ct_size);
}

int32_t fhe_tpu_decode_scalar(const char* tname, const uint64_t* poly,
                              uint8_t** out, int64_t* out_len) {
  return fheabi::tpu_decode_scalar(tname, poly, out, out_len);
}

int32_t fhe_tpu_unpack_reencrypt(const uint8_t* data, size_t data_len,
                                 uint64_t* ct, uint64_t* ct_size,
                                 void** pk_handle) {
  return fheabi::tpu_unpack_reencrypt(data, data_len, ct, ct_size,
                                      pk_handle);
}

int32_t fhe_tpu_reencrypt_finish(const char* tname, const uint8_t* data,
                                 size_t data_len, const uint64_t* poly,
                                 uint64_t* m, uint8_t* seed64) {
  return fheabi::tpu_reencrypt_finish(tname, data, data_len, poly, m,
                                      seed64);
}

int32_t fhe_tpu_pk_data(void* pk_handle, uint64_t* pk_out) {
  return fheabi::tpu_pk_data(pk_handle, pk_out);
}

}  // extern "C"

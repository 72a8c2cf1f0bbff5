// Modular primitives on native 64-bit words for the BEHZ tail and NTT kernels.
//
// The tail kernels' moduli are primes with 2^32 < p < 2^37; the NTT kernels
// use csub and the Shoup product only, which hold for any p < 2^61 (see
// ntt.cu).  Residues are stored as
// 8-byte words (torch.int64 on the Python side, never negative), read here as
// unsigned long long.  Two division-free products:
//
//   Shoup    a * w mod p for a constant w with ws = floor(w * 2^64 / p)
//            computed on the host from a canonical w.  `a` may be any 64-bit
//            value: q = hi64(a * ws) underestimates a*w/p by less than
//            1 + a/2^64, so a*w - q*p lies in [0, 2p).
//   Barrett  x mod p for any 64-bit x with mu = floor(2^64 / p):
//            q = hi64(x * mu) underestimates x/p by less than 1 + x/2^64,
//            so x - q*p lies in [0, 2p) and one conditional subtract ends it.
//
// The general product of two canonical residues (up to 74 bits) goes through
// the 128-bit product: hi * (2^64 mod p) + (lo mod p) < 2^48, one more
// Barrett step.  2^64 mod p is 0 - mu*p in 64-bit arithmetic.
#pragma once
#include <cstdint>

typedef unsigned long long u64;

__device__ __forceinline__ u64 csub(u64 x, u64 p) { return x >= p ? x - p : x; }

__device__ __forceinline__ u64 addmod(u64 a, u64 b, u64 p) { return csub(a + b, p); }

__device__ __forceinline__ u64 submod(u64 a, u64 b, u64 p) {
    return a >= b ? a - b : a + (p - b);
}

// a * w - floor(a * ws / 2^64) * p, in [0, 2p)
__device__ __forceinline__ u64 mul_shoup_lazy(u64 a, u64 w, u64 ws, u64 p) {
    return a * w - __umul64hi(a, ws) * p;
}

__device__ __forceinline__ u64 mul_shoup(u64 a, u64 w, u64 ws, u64 p) {
    return csub(mul_shoup_lazy(a, w, ws, p), p);
}

// x mod p for any 64-bit x
__device__ __forceinline__ u64 barrett(u64 x, u64 p, u64 mu) {
    return csub(x - __umul64hi(x, mu) * p, p);
}

// a * b reduced to a value < 2^48 that is congruent to a*b mod p
// (a, b < 2^37, so the high word of the product is < 2^10)
__device__ __forceinline__ u64 mul_lazy(u64 a, u64 b, u64 p, u64 mu) {
    u64 c64 = 0ull - mu * p;                    // 2^64 mod p
    return __umul64hi(a, b) * c64 + barrett(a * b, p, mu);
}

__device__ __forceinline__ u64 mulmod(u64 a, u64 b, u64 p, u64 mu) {
    return barrett(mul_lazy(a, b, p, mu), p, mu);
}

// Modular primitives on native 64-bit words for the BEHZ tail and NTT kernels.
//
// The tail kernels' moduli are primes with 2^32 < p < 2^37; the NTT kernels
// use csub, csub_signed and the 40-bit Shoup product below, which hold for
// any p < 2^37.  Residues are stored as
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

// x - m if x >= m, else x, for x, m < 2^63: the sign of the difference
// picks.  Written in PTX, as the compiler's own form of the C expression
// measured slower in the forward NTT on an H100.
__device__ __forceinline__ u64 csub_signed(u64 x, u64 m) {
    u64 r;
    asm("{\n\t"
        ".reg .u32 x0, x1, m0, m1, d0, d1;\n\t"
        ".reg .pred neg;\n\t"
        "mov.b64 {x0, x1}, %1;\n\t"
        "mov.b64 {m0, m1}, %2;\n\t"
        "sub.cc.u32 d0, x0, m0;\n\t"
        "subc.u32 d1, x1, m1;\n\t"
        "setp.lt.s32 neg, d1, 0;\n\t"
        "selp.b32 d0, x0, d0, neg;\n\t"
        "selp.b32 d1, x1, d1, neg;\n\t"
        "mov.b64 %0, {d0, d1};\n\t"
        "}" : "=l"(r) : "l"(x), "l"(m));
    return r;
}

// An integer x < 2^52 as a double, exactly: x's bits under the exponent of
// 2^52 are the double 2^52 + x, and the subtraction is exact.
__device__ __forceinline__ double exact_double(u64 x) {
    const long long bits = (long long)(0x4330000000000000ull | x);
    return __dsub_rn(__longlong_as_double(bits), 0x1p52);
}

// The NTT kernels' product: a*w - q*p with Harvey's beta = 40 quotient
// q = floor(a * ws40 / 2^40), ws40 = floor(w * 2^40 / p), for a < 2^39 and
// w < p < 2^37.  q underestimates a*w/p by less than 1 + a/2^40, so the
// result lies in [0, p * (1 + a/2^40)), below 1.5p for a < 4p: the lazy
// contract of the JAX package's mulmod_shoup40.  Formed on the FP64 pipe,
// every step exact.  Inputs as doubles: w and p exactly, ws = ws40 * 2^-40
// (exact: a power-of-two scale of an integer below 2^40).
//   q: fma(a, ws, 2^52) rounded down lands in [2^52, 2^53), where the doubles
//      are the integers: it is 2^52 + q.
//   h = a*w rounded; l = fma(a, w, -h) = a*w - h exactly (|l| <= 2^22, as
//      a*w < 2^76).
//   t = fma(-q, p, h) = h - q*p exactly: it is the integer r - l, far below
//      2^53.  r = t + l, an integer below 2^38, read back through 2^52.
__device__ __forceinline__ u64 mul_shoup40_lazy(u64 a, double w, double ws,
                                                double p) {
    const double ad = exact_double(a);
    const double q = __dsub_rn(__fma_rd(ad, ws, 0x1p52), 0x1p52);
    const double h = __dmul_rn(ad, w);
    const double l = __fma_rn(ad, w, -h);
    const double t = __fma_rn(-q, p, h);
    return (u64)__double_as_longlong(__dadd_rn(t, __dadd_rn(l, 0x1p52)))
           & 0xFFFFFFFFFFFFFull;
}

// The same product for a sum of terms (floor_sk): a, w, ws and p as doubles,
// a an integer below 2^39, and the term r = a*w - q*p returned as a double,
// exactly (r < 2^52: t + l is an integer that a double holds).  A sum of
// such terms stays exact while it is below 2^53.  The scale of the Shoup
// word is the caller's: with ws = floor(w * 2^52 / p) * 2^-52 and a < 2^50
// (four_step.cu's fold), q = floor(a * ws) and r < p (1 + a / 2^52).
__device__ __forceinline__ double shoup40_d(double a, double w, double ws,
                                           double p) {
    const double q = __dsub_rn(__fma_rd(a, ws, 0x1p52), 0x1p52);
    const double h = __dmul_rn(a, w);
    const double l = __fma_rn(a, w, -h);
    return __dadd_rn(__fma_rn(-q, p, h), l);
}

// An integer-valued double 0 <= x < 2^52 as an integer: the low bits of
// x + 2^52.
__device__ __forceinline__ u64 exact_u64(double x) {
    return (u64)__double_as_longlong(__dadd_rn(x, 0x1p52))
           & 0xFFFFFFFFFFFFFull;
}

// x - m if x >= m, else x, for integer-valued doubles below 2^53
__device__ __forceinline__ double csub_d(double x, double m) {
    const double d = __dsub_rn(x, m);
    return d >= 0.0 ? d : x;
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

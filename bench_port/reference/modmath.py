"""Vectorized exact modular arithmetic over numpy uint64.

All ciphertext-level moduli are NTT-friendly primes p < 2**37 (params.py
validates this), which lets every 64-bit modular product be computed exactly
in uint64 via a 19-bit split -- no 128-bit arithmetic needed anywhere:

    a*b = (a_hi * b) * 2**19 + a_lo * b,   a_hi < 2**18, a_lo < 2**19
    each partial product < 2**57, so ((a_hi*b) % p) << 19 and a_lo*b both
    fit uint64 and the final sum < 2**57 is reduced by one more % p.

This is the semantic reference the benchmark holds the program's results
to, bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np

_MASK19 = np.uint64((1 << 19) - 1)
_SHIFT19 = np.uint64(19)

U64 = np.uint64


def addmod(a, b, p):
    """(a + b) mod p for a,b < p < 2**63."""
    p = np.uint64(p)
    s = a + b
    return np.where(s >= p, s - p, s)


def submod(a, b, p):
    """(a - b) mod p for a,b < p."""
    p = np.uint64(p)
    return np.where(a >= b, a - b, a + (p - b))


def negmod(a, p):
    p = np.uint64(p)
    return np.where(a == 0, a, p - a)


def mulmod(a, b, p):
    """(a * b) mod p, exact, for a,b < p < 2**37 (uint64 arrays)."""
    p = np.uint64(p)
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    ah = a >> _SHIFT19
    al = a & _MASK19
    hi = ((ah * b) % p) << _SHIFT19          # < 2**56
    return (hi + al * b) % p                  # < 2**57 before reduction


def powmod(base: int, exp: int, p: int) -> int:
    return pow(int(base), int(exp), int(p))


def invmod(a: int, p: int) -> int:
    return pow(int(a), -1, int(p))


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def minimal_primitive_root(two_n: int, p: int) -> int:
    """Minimal primitive `two_n`-th root of unity mod p (SEAL convention).

    SEAL stores keys in NTT form built on its *minimal* primitive root, so
    interoperating with SEAL key blobs requires the same choice.  two_n must be a power of two dividing p-1.
    """
    if (p - 1) % two_n != 0:
        raise ValueError(f"{p} has no primitive {two_n}-th root")
    # find any element of order two_n: g^((p-1)/two_n) for random g until
    # the order is exactly two_n (i.e. its two_n/2 power is != 1).
    exp = (p - 1) // two_n
    root = None
    for g in range(2, 10_000):
        r = pow(g, exp, p)
        if pow(r, two_n // 2, p) != 1:
            root = r
            break
    if root is None:  # pragma: no cover - practically unreachable for primes
        raise ValueError("no primitive root found")
    # minimal over all primitive roots = min over odd powers of `root`
    root_sq = root * root % p
    cur = root
    best = root
    for _ in range(two_n // 2):
        if cur < best:
            best = cur
        cur = cur * root_sq % p
    return best


class NttTables:
    """Per-(p, n) twiddle tables in bit-reversed (Longa-Naehrig) layout.

    root_powers[j] = psi**bit_reverse(j, log2(n)) -- the forward table.
    inv_root_powers[j] = inverse of root_powers[j] elementwise.
    The forward transform consumes root_powers[m..2m) at the stage with m
    blocks; output lands in SEAL-compatible bit-reversed "NTT form".
    """

    def __init__(self, p: int, n: int):
        self.p = int(p)
        self.n = int(n)
        self.log_n = n.bit_length() - 1
        assert 1 << self.log_n == n
        self.psi = minimal_primitive_root(2 * n, p)
        self.psi_inv = invmod(self.psi, p)
        self.n_inv = np.uint64(invmod(n, p))

        idx = np.arange(n)
        brv = np.array([bit_reverse(int(i), self.log_n) for i in idx])
        acc = 1
        pows = np.empty(n, dtype=object)
        for i in range(n):
            pows[i] = acc
            acc = acc * self.psi % p
        self.root_powers = np.array([pows[b] for b in brv], dtype=np.uint64)
        self.inv_root_powers = np.array(
            [invmod(int(x), p) for x in self.root_powers], dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def get_ntt_tables(p: int, n: int) -> NttTables:
    return NttTables(p, n)

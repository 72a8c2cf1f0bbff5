"""Vectorized 128-bit unsigned arithmetic on (hi, lo) uint64 numpy pairs.

Supports the exact CRT composition x = sum_j y_j * q_hat_j (mod q) used by
noise accounting: for <= 3 ciphertext limbs, every intermediate fits 128
bits (q < 2**111, k*q < 2**113), so the composition is division-free --
multiply by constants, 128-bit adds, then at most k-1 conditional
subtractions of q.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_U64 = np.uint64
_MASK32 = _U64(0xFFFFFFFF)

U128 = Tuple[np.ndarray, np.ndarray]     # (hi, lo)


def zeros(shape) -> U128:
    return (np.zeros(shape, dtype=np.uint64),
            np.zeros(shape, dtype=np.uint64))


def from_int(value: int, shape) -> U128:
    if not 0 <= value < 1 << 128:
        raise ValueError("constant out of u128 range")
    return (np.full(shape, value >> 64, dtype=np.uint64),
            np.full(shape, value & (2**64 - 1), dtype=np.uint64))


def add(a: U128, b: U128) -> U128:
    lo = a[1] + b[1]
    carry = (lo < b[1]).astype(np.uint64)
    return a[0] + b[0] + carry, lo


def sub(a: U128, b: U128) -> U128:
    lo = a[1] - b[1]
    borrow = (a[1] < b[1]).astype(np.uint64)
    return a[0] - b[0] - borrow, lo


def geq(a: U128, b: U128) -> np.ndarray:
    return (a[0] > b[0]) | ((a[0] == b[0]) & (a[1] >= b[1]))


def select(cond: np.ndarray, a: U128, b: U128) -> U128:
    return np.where(cond, a[0], b[0]), np.where(cond, a[1], b[1])


def mul_const(y: np.ndarray, c: int) -> U128:
    """y (uint64 array) * c (int < 2**96), exact, result < 2**128 required."""
    if not 0 <= c < 1 << 96:
        raise ValueError("constant too large for this multiply")
    y = np.asarray(y, dtype=np.uint64)
    ylo = y & _MASK32
    yhi = y >> _U64(32)
    out = zeros(y.shape)
    for di, d in enumerate([(c >> (32 * i)) & 0xFFFFFFFF for i in range(3)]):
        if d == 0:
            continue
        d64 = _U64(d)
        for (part, extra_shift) in ((ylo * d64, 0), (yhi * d64, 32)):
            s = 32 * di + extra_shift
            if s < 64:
                lo = part << _U64(s) if s else part
                hi = part >> _U64(64 - s) if s else np.zeros_like(part)
            else:
                lo = np.zeros_like(part)
                hi = part << _U64(s - 64) if s > 64 else part
            out = add(out, (hi, lo))
    return out


def to_ints(a: U128) -> np.ndarray:
    """Object array of exact python ints (for final scalar extraction)."""
    return (a[0].astype(object) << 64) + a[1].astype(object)


def max_value(a: U128) -> int:
    """Maximum element as a python int (lexicographic on (hi, lo))."""
    top = a[0].max()
    lo_at_top = a[1][a[0] == top].max()
    return (int(top) << 64) | int(lo_at_top)

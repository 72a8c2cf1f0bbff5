"""Plaintext-type polynomial encodings: Signed / Unsigned64 / Unsigned256 /
Fractional<64>.

The port's own copy of ``fhe_precompiles_tpu/encoding.py``.  Parity target:
sunscreen's BFV plaintext types (used throughout the reference's
``src/fhe.rs``; byte-level outputs at fhe.rs:688-699 are the big-endian
scalars of ``pack.rs:47-104``).  The encodings are the standard
sunscreen ones:

* Unsigned/Signed: binary digit i of |v| at coefficient i; negative values
  negate every coefficient mod t (signed-digit representation).
* Fractional<64>: integer bit i (0 <= i < 64) at coefficient i; fractional bit
  2^-j at coefficient n-j with a negated coefficient, exploiting x^n = -1.

Decoding interprets each coefficient as a *centered* residue in
(-t/2, t/2] and composes exactly with big ints / Fractions, so values that
grew through homomorphic ops (carries beyond one bit per digit) decode
correctly; out-of-range results raise Overflow (error code 4, lib.rs:21).
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

from .errors import overflow
from .params import Params


def _centered(coeffs: np.ndarray, t: int) -> np.ndarray:
    """Centered residues in (-t/2, t/2] as an int64 array (vectorized)."""
    c = np.asarray(coeffs).astype(np.int64)
    return c - np.int64(t) * (c > t // 2)


def _compose(c: np.ndarray) -> int:
    """Exact sum(c[i] << i) for centered int64 coefficients, |c[i]| < 2**15.

    Python-loop-free: split by bit-class i mod 16 so each class packs into
    non-overlapping 16-bit lanes of one big integer (int.from_bytes), then
    combine the 16 classes with big-int shifts.  ~30x faster than the naive
    per-coefficient loop at n=4096.
    """
    pos = np.where(c > 0, c, 0).astype("<u2")
    neg = np.where(c < 0, -c, 0).astype("<u2")
    total = 0
    for r in range(16):
        p_lane = pos[r::16]
        n_lane = neg[r::16]
        lane = (int.from_bytes(p_lane.tobytes(), "little")
                - int.from_bytes(n_lane.tobytes(), "little"))
        if lane:
            total += lane << r
    return total


def encode_unsigned(value: int, params: Params, bits: int) -> np.ndarray:
    if not 0 <= value < 1 << bits:
        raise overflow(f"unsigned{bits} out of range")
    n, t = params.n, params.t
    out = np.zeros(n, dtype=np.uint64)
    i = 0
    v = int(value)
    while v:
        out[i] = v & 1
        v >>= 1
        i += 1
    return out


def decode_unsigned(coeffs: np.ndarray, params: Params, bits: int) -> int:
    val = _compose(_centered(coeffs, params.t))
    if not 0 <= val < 1 << bits:
        raise overflow(f"decoded value does not fit unsigned{bits}")
    return val


def encode_signed(value: int, params: Params) -> np.ndarray:
    if not -(1 << 63) <= value < 1 << 63:
        raise overflow("i64 out of range")
    mag = encode_unsigned(abs(int(value)), params, 64)
    if value < 0:
        t = np.uint64(params.t)
        mag = np.where(mag != 0, t - mag, mag)
    return mag


def decode_signed(coeffs: np.ndarray, params: Params) -> int:
    val = _compose(_centered(coeffs, params.t))
    if not -(1 << 63) <= val < 1 << 63:
        raise overflow("decoded value does not fit i64")
    return val


#: Fractional<64>: 64 integer bits, the rest of the ring carries fractional bits.
FRAC_INT_BITS = 64


def encode_frac64(value: float, params: Params) -> np.ndarray:
    n, t = params.n, params.t
    f = Fraction(float(value))  # exact binary fraction (f64 is dyadic)
    neg = f < 0
    f = abs(f)
    int_part = int(f)
    frac_part = f - int_part
    if int_part >= 1 << FRAC_INT_BITS:
        raise overflow("fractional integer part out of range")
    out = np.zeros(n, dtype=np.uint64)
    i = 0
    v = int_part
    while v:
        out[i] = v & 1
        v >>= 1
        i += 1
    # fractional bits: bit 2^-j -> coefficient n-j, negated (x^n = -1)
    j = 1
    max_frac = n - FRAC_INT_BITS
    while frac_part and j <= max_frac:
        frac_part *= 2
        if frac_part >= 1:
            out[n - j] = t - 1
            frac_part -= 1
        j += 1
    if frac_part:
        raise overflow("fractional part needs more precision than the ring has")
    if neg:
        tt = np.uint64(t)
        out = np.where(out != 0, tt - out, out)
    return out


def decode_frac64(coeffs: np.ndarray, params: Params) -> float:
    n, t = params.n, params.t
    c = _centered(coeffs, t)
    int_part = _compose(c[:FRAC_INT_BITS])
    # fractional terms: -sum_j c[n-j] 2^-j = -compose(c[64:]) / 2^(n-64)
    # (index i of the tail slice has i = n - 64 - j <=> weight 2^(i-(n-64)))
    frac_num = _compose(c[FRAC_INT_BITS:])
    val = Fraction(int_part) - Fraction(frac_num, 1 << (n - FRAC_INT_BITS))
    return float(val)


# ---- SIMD slot packing (BatchEncoder) ------------------------------------

class BatchEncoder:
    """Packed-slot plaintext encoder (SEAL BatchEncoder analog).

    Requires a prime plain modulus t with 2n | t-1 (e.g. the bench.n8192
    preset): the plaintext ring Z_t[x]/(x^n+1) then splits into n slots via
    the mod-t negacyclic NTT, so one homomorphic op acts elementwise on n
    packed values.  Slot order is this framework's NTT
    form (bit-reversed); documented, self-consistent.
    """

    def __init__(self, params: Params):
        from .bfv.modmath import get_ntt_tables
        t = params.t
        if (t - 1) % (2 * params.n) != 0:
            raise ValueError(
                f"plain modulus {t} has no 2n-th root of unity; "
                "choose t = 1 (mod 2n) for slot packing")
        self._tables = get_ntt_tables(t, params.n)
        self.params = params
        self.slot_count = params.n

    def encode(self, values: np.ndarray) -> np.ndarray:
        """Pack n mod-t slot values into a plaintext polynomial."""
        from .bfv.ntt import intt
        vals = np.asarray(values, dtype=np.uint64)
        if vals.shape[-1] != self.slot_count:
            raise ValueError(f"expected {self.slot_count} slots")
        if (vals >= self.params.t).any():
            raise overflow("slot value out of range")
        return intt(vals, self._tables)

    def decode(self, poly: np.ndarray) -> np.ndarray:
        """Unpack a plaintext polynomial into its n slot values."""
        from .bfv.ntt import ntt as fwd
        return fwd(np.asarray(poly, dtype=np.uint64), self._tables)


# ---- type-tag table used by the app layer --------------------------------

class PlainType:
    """A plaintext type: scalar codec glue + polynomial encode/decode."""

    def __init__(self, name: str, encode, decode):
        self.name = name
        self.encode = encode
        self.decode = decode

    def __repr__(self):
        return f"PlainType({self.name})"


U256_TYPE = PlainType(
    "u256",
    lambda v, p: encode_unsigned(v, p, 256),
    lambda c, p: decode_unsigned(c, p, 256))
U64_TYPE = PlainType(
    "u64",
    lambda v, p: encode_unsigned(v, p, 64),
    lambda c, p: decode_unsigned(c, p, 64))
I64_TYPE = PlainType("i64", encode_signed, decode_signed)
FRAC64_TYPE = PlainType("frac64", encode_frac64, decode_frac64)

PLAIN_TYPES = {t.name: t for t in (U256_TYPE, U64_TYPE, I64_TYPE, FRAC64_TYPE)}

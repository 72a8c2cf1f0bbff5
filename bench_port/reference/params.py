"""BFV parameter sets.

The benchmark's frozen copy of the parameter sets; the configurations under
``bench_port/configs/`` name their numbers, and the reference builds its
``Params`` from those numbers with this class.

``testnet.one`` is Sunscreen's testnet parameter set: ``lattice_dimension:
4096, coeff_modulus: [0xffffee001, 0xffffc4001, 0x1ffffe0001],
plain_modulus: 4096``.

SEAL semantics (which sunscreen inherits and which our wire format follows):
the *last* prime of ``coeff_modulus`` is the "special" key-switching prime.
Fresh ciphertexts live in the RNS base of all primes *except* the last one
(2 limbs for testnet-one); keys (public key, relin keys) live in the full base
(3 limbs).  When there is only a single prime there is no special prime and no
key-switching support.

Every parameter set also carries the derived auxiliary RNS base used by the
BEHZ RNS multiply (``aux_moduli`` + ``m_sk`` + ``m_tilde``), chosen as
NTT-friendly primes < 2**37 so that all residue arithmetic shares one set of
modular primitives.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple


def _is_prime(x: int) -> bool:
    if x < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if x % p == 0:
            return x == p
    d, s = x - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        v = pow(a, d, x)
        if v in (1, x - 1):
            continue
        for _ in range(s - 1):
            v = v * v % x
            if v == x - 1:
                break
        else:
            return False
    return True


def ntt_friendly_primes(n: int, count: int, below: int = 1 << 37,
                        exclude: Tuple[int, ...] = ()) -> Tuple[int, ...]:
    """Deterministically pick `count` primes p < `below` with p ≡ 1 (mod 2n).

    Scans downward from `below` so every party derives the identical base for
    a given parameter set (the aux base is part of the canonical ciphertext
    arithmetic, so it must be globally agreed).
    """
    step = 2 * n
    p = (below - 1) - ((below - 1) % step) + 1
    out = []
    while len(out) < count:
        if p < (1 << 20):
            raise ValueError("ran out of NTT-friendly primes")
        if p not in exclude and _is_prime(p):
            out.append(p)
        p -= step
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Params:
    """A BFV parameter set (immutable, hashable)."""

    poly_modulus_degree: int                 # n, power of two
    coeff_modulus: Tuple[int, ...]           # full (key-level) RNS base, special prime last
    plain_modulus: int                       # t
    scheme_type: str = "bfv"
    security_level: str = "tc128"

    # ---- derived RNS structure -------------------------------------------
    @property
    def n(self) -> int:
        return self.poly_modulus_degree

    @property
    def key_moduli(self) -> Tuple[int, ...]:
        """Full base used by keys (pk / relin keys)."""
        return self.coeff_modulus

    @property
    def ct_moduli(self) -> Tuple[int, ...]:
        """Base of fresh ciphertexts: special prime dropped when present."""
        if len(self.coeff_modulus) > 1:
            return self.coeff_modulus[:-1]
        return self.coeff_modulus

    @property
    def special_modulus(self) -> int | None:
        if len(self.coeff_modulus) > 1:
            return self.coeff_modulus[-1]
        return None

    @property
    def t(self) -> int:
        return self.plain_modulus

    @functools.cached_property
    def q(self) -> int:
        """Ciphertext modulus q = prod(ct_moduli)."""
        return math.prod(self.ct_moduli)

    @functools.cached_property
    def delta(self) -> int:
        """BFV plaintext scale Δ = floor(q / t)."""
        return self.q // self.t

    # ---- BEHZ auxiliary base (for the RNS ct*ct multiply) -----------------
    @functools.cached_property
    def _behz_base(self) -> Tuple[Tuple[int, ...], int]:
        """(B, m_sk): aux base sized so the BEHZ bounds hold with headroom.

        Requirements (BEHZ'16, "A Full RNS Variant of FV"):
          * q * prod(B) * m_sk  >  2 * tensor_max   (tensor products exact)
          * prod(B) * m_sk      >  2 * floor_max    (Shenoy-Kumaresan exact)
        with tensor_max = 2n * c_max^2, c_max = q*(k+2) after SmMRq, and
        floor_max ~= tensor_max * t / q.
        """
        k = len(self.ct_moduli)
        c_max = self.q * (k + 2)
        tensor_max = 2 * self.n * c_max * c_max
        floor_max = tensor_max * self.t // self.q + (k + 1) * self.q
        count = k
        while True:
            primes = ntt_friendly_primes(self.n, count + 1,
                                         exclude=self.coeff_modulus)
            base, m_sk = primes[:count], primes[count]
            prod_b = math.prod(base)
            if (self.q * prod_b * m_sk > 2 * tensor_max
                    and prod_b * m_sk > 2 * floor_max):
                return base, m_sk
            count += 1

    @property
    def aux_moduli(self) -> Tuple[int, ...]:
        """Base B: NTT-friendly primes disjoint from q (BEHZ multiply)."""
        return self._behz_base[0]

    @property
    def m_sk(self) -> int:
        """Shenoy-Kumaresan redundant prime (one more NTT-friendly prime)."""
        return self._behz_base[1]

    @property
    def m_tilde(self) -> int:
        """BEHZ redundant Montgomery modulus (power of two, coprime to all)."""
        return 1 << 16

    @functools.cached_property
    def gamma(self) -> int:
        """Correction prime for RNS decryption scale-and-round (t-gamma
        technique); distinct from every other modulus in use."""
        aux = self.aux_moduli
        return ntt_friendly_primes(self.n, len(aux) + 2,
                                   exclude=self.coeff_modulus)[-1]

    @property
    def bsk_moduli(self) -> Tuple[int, ...]:
        return self.aux_moduli + (self.m_sk,)

    def validate(self) -> None:
        n = self.poly_modulus_degree
        if n & (n - 1) or n < 8:
            raise ValueError(f"n must be a power of two >= 8, got {n}")
        for p in self.coeff_modulus:
            if p % (2 * n) != 1:
                raise ValueError(f"modulus {p:#x} is not NTT-friendly for n={n}")
            if p >= 1 << 37:
                # the 19-bit-split modular multiply is exact only below
                # 2**37
                raise ValueError(f"modulus {p:#x} too large (>= 2^37)")
        if len(set(self.coeff_modulus)) != len(self.coeff_modulus):
            raise ValueError("duplicate coeff moduli")

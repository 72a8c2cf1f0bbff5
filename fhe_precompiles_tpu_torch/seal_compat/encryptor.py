"""SEAL 4.0 deterministic public-key encryption, byte-exact.

Reproduces sunscreen's ``runtime.encrypt_deterministic(plain, pk, seed)``
(reference fhe.rs:613-616): SEAL's ``encrypt_zero_asymmetric``
(util/rlwe.cpp) consumes one Blake2xb PRNG stream in the order

    u  <- sample_poly_ternary   (one u32 draw per coefficient)
    e0 <- sample_poly_cbd       (6 bytes per coefficient)
    e1 <- sample_poly_cbd

then c_j = INTT(NTT(u) o pk_j) + e_j mod q, and
``multiply_add_plain_with_scaling_variant`` adds round(q*m/t) to c0.
The modular algebra is exact, so the golden model's
``encrypt_with_randomness`` reproduces SEAL's output words bit-for-bit
given SEAL's randomness.
"""
from __future__ import annotations

import numpy as np

from ..bfv.golden import BfvContext, Ciphertext, PublicKey
from .prng import Blake2xbPrng
from .sampler import sample_poly_cbd, sample_poly_ternary


def seal_randomness(seed: bytes, n: int):
    """(u, e0, e1) exactly as SEAL's encryptor draws them for one encrypt."""
    prng = Blake2xbPrng(seed)
    u = sample_poly_ternary(prng, n)
    e0 = sample_poly_cbd(prng, n)
    e1 = sample_poly_cbd(prng, n)
    return u, e0, e1


def encrypt_deterministic(ctx: BfvContext, plain: np.ndarray, pk: PublicKey,
                          seed: bytes) -> Ciphertext:
    """SEAL-byte-exact deterministic encryption (seed = 64 bytes / 8 u64)."""
    u, e0, e1 = seal_randomness(seed, ctx.n)
    return ctx.encrypt_with_randomness(plain, pk, u, e0, e1)

"""SEAL 4.0 byte-compatibility layer.

The port's own copy of ``fhe_precompiles_tpu/seal_compat/`` (pure numpy,
same semantics), over the port's ``bfv/golden.py``.

The reference's deterministic-encryption consensus fixtures
(its ``src/fhe.rs:2083-2245``) pin SHA-512 digests of the exact
output bytes of ``encrypt``/``reencrypt``.  Reproducing them requires the
precise randomness expansion and sampler semantics of the SEAL 4.0 build
that sunscreen 0.8.1 links (Blake2xb counter PRNG, libstdc++
``std::uniform_int_distribution`` ternary sampling, 21-bit centered-binomial
noise), plus SEAL's serialization (zstd level 3) and sunscreen's serde
bincode framing.  This package implements exactly that; the golden hashes
are the accept oracle.
"""
from .blake2xb import blake2xb
from .prng import Blake2xbPrng
from .sampler import sample_poly_cbd, sample_poly_ternary

__all__ = ["blake2xb", "Blake2xbPrng", "sample_poly_cbd",
           "sample_poly_ternary"]

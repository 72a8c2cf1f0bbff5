"""Deterministic samplers for key generation and encryption randomness.

The benchmark's frozen copy of the samplers.  The consensus
model requires that the same (value, seed) always produce bit-identical
ciphertexts on every validator: a counter-mode BLAKE2b XOF keyed by a 64-byte
seed, pinned by golden-byte tests.

All sampling is host-side numpy (cheap next to the NTTs) so every device
sees identical streams by construction.
"""
from __future__ import annotations

import hashlib

import numpy as np

SEED_BYTES = 64  # 512-bit seeds ([u64; 8] on the wire)


class Blake2Xof:
    """Counter-mode BLAKE2b expandable output function.

    block_i = BLAKE2b-64(seed || le64(domain) || le64(i)); deterministic and
    platform-independent.
    """

    def __init__(self, seed: bytes, domain: int):
        if len(seed) != SEED_BYTES:
            raise ValueError(f"seed must be {SEED_BYTES} bytes")
        self._prefix = seed + int(domain).to_bytes(8, "little")
        self._counter = 0
        self._buf = b""

    def read(self, nbytes: int) -> bytes:
        chunks = [self._buf]
        have = len(self._buf)
        while have < nbytes:
            block = hashlib.blake2b(
                self._prefix + self._counter.to_bytes(8, "little"),
                digest_size=64).digest()
            self._counter += 1
            chunks.append(block)
            have += 64
        data = b"".join(chunks)
        self._buf = data[nbytes:]
        return data[:nbytes]

    def u64(self, count: int) -> np.ndarray:
        return np.frombuffer(self.read(8 * count), dtype="<u8").copy()


# Domain-separation tags for the different random streams of one encryption /
# keygen.  Part of the canonical format: changing any of these changes all
# ciphertext bytes.
DOMAIN_TERNARY = 0x7465726E            # b"tern"
DOMAIN_ERROR = 0x6572726F              # b"erro"
DOMAIN_UNIFORM = 0x756E6966            # b"unif"
DOMAIN_KEYGEN = 0x6B657967             # b"keyg"

#: Centered-binomial parameter: variance = CBD_K / 2 = 10.5, sigma ~= 3.24,
#: matching the security target of SEAL's sigma = 3.2 rounded Gaussian.
CBD_K = 21


def seed_from_u64s(words) -> bytes:
    """[u64; 8] -> 64 little-endian bytes."""
    return b"".join(int(w).to_bytes(8, "little") for w in words)


def sample_uniform_mod(xof: Blake2Xof, p: int, n: int) -> np.ndarray:
    """n uniform values in [0, p) by rejection from u64 (bias-free)."""
    p = int(p)
    bound = (1 << 64) - ((1 << 64) % p)  # rejection threshold
    out = np.empty(n, dtype=np.uint64)
    filled = 0
    while filled < n:
        need = n - filled
        draws = xof.u64(need + need // 8 + 8)
        good = draws[draws < np.uint64(bound)][:need]
        out[filled:filled + len(good)] = good
        filled += len(good)
    return out % np.uint64(p)


def sample_ternary(xof: Blake2Xof, n: int) -> np.ndarray:
    """Uniform ternary secret in {-1, 0, 1}, returned as int64."""
    # rejection-sample 2-bit values, mapping 0,1,2 -> -1,0,1
    out = np.empty(n, dtype=np.int64)
    filled = 0
    while filled < n:
        need = n - filled
        raw = np.frombuffer(xof.read(need + need // 2 + 8), dtype=np.uint8)
        vals = raw & 3
        good = vals[vals < 3][:need]
        out[filled:filled + len(good)] = good.astype(np.int64) - 1
        filled += len(good)
    return out


def sample_cbd(xof: Blake2Xof, n: int, k: int = CBD_K) -> np.ndarray:
    """Centered binomial noise: sum(k bits) - sum(k bits), int64 in [-k, k]."""
    nbits = 2 * k * n
    raw = np.frombuffer(xof.read((nbits + 7) // 8), dtype=np.uint8)
    bits = np.unpackbits(raw, count=nbits).reshape(n, 2, k)
    pos = bits[:, 0, :].sum(axis=1).astype(np.int64)
    neg = bits[:, 1, :].sum(axis=1).astype(np.int64)
    return pos - neg


def signed_to_rns(poly: np.ndarray, moduli) -> np.ndarray:
    """Lift a small signed int64 polynomial to RNS residues, shape (k, n)."""
    out = np.empty((len(moduli), poly.shape[-1]), dtype=np.uint64)
    for j, p in enumerate(moduli):
        out[j] = np.mod(poly, np.int64(p)).astype(np.uint64)
    return out

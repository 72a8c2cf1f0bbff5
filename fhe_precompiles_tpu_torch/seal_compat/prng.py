"""SEAL 4.0 ``Blake2xbPRNG``: counter-mode BLAKE2xb byte stream.

SEAL's ``UniformRandomGenerator`` (util/rng.h) keeps a 4096-byte buffer;
each refill computes ``blake2xb(buffer, 4096, in=&counter (u64 LE),
key=seed (8 x u64 LE = 64 bytes))`` and then increments the counter
(starting from 0).  ``generate(n)`` serves bytes sequentially across
refills.  The seed is SEAL's ``prng_seed_type`` = ``array<uint64_t, 8>``;
the reference passes SHA-512 digests reinterpreted as LE u64s
(fhe.rs:47-54), which is byte-identity on the wire.
"""
from __future__ import annotations

import struct

from .blake2xb import blake2xb

BUFFER_BYTES = 4096


class Blake2xbPrng:
    def __init__(self, seed: bytes, buffer_bytes: int = BUFFER_BYTES):
        if len(seed) != 64:
            raise ValueError("seed must be 64 bytes (8 x u64)")
        self._seed = seed
        self._buffer_bytes = buffer_bytes
        self._counter = 0
        self._buf = b""
        self._pos = 0

    def _refill(self) -> None:
        self._buf = blake2xb(self._buffer_bytes,
                             struct.pack("<Q", self._counter), self._seed)
        self._counter += 1
        self._pos = 0

    def generate(self, nbytes: int) -> bytes:
        out = bytearray()
        while nbytes > 0:
            if self._pos >= len(self._buf):
                self._refill()
            take = min(nbytes, len(self._buf) - self._pos)
            out += self._buf[self._pos:self._pos + take]
            self._pos += take
            nbytes -= take
        return bytes(out)

    def u32(self) -> int:
        """SEAL's ``RandomToStandardAdapter``: one uint32 per call (LE)."""
        return struct.unpack("<I", self.generate(4))[0]

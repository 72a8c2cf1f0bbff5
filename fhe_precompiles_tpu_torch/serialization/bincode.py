"""Minimal bincode (legacy/default config) reader & writer.

The port's own copy of ``fhe_precompiles_tpu/serialization/bincode.py``.

Covers exactly the subset the sunscreen 0.8.1 types use: fixed-width
little-endian ints, f64, ``Vec<u8>``/``String`` as u64 length + raw bytes,
``Option<T>`` as a 1-byte tag, enum variants as u32 tags.
"""
from __future__ import annotations

import struct

from ..errors import invalid_encoding


class Reader:
    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.off = offset

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise invalid_encoding("bincode input truncated")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def byte_vec(self) -> bytes:
        n = self.u64()
        return self._take(n)

    def option(self) -> bool:
        tag = self.u8()
        if tag not in (0, 1):
            raise invalid_encoding(f"bad Option tag {tag}")
        return tag == 1

    def remaining(self) -> int:
        return len(self.data) - self.off

    def expect_end(self) -> None:
        if self.remaining():
            raise invalid_encoding(f"{self.remaining()} trailing bytes")


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u8(self, v: int):
        self.parts.append(bytes([v]))

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def f64(self, v: float):
        self.parts.append(struct.pack("<d", v))

    def raw(self, b: bytes):
        self.parts.append(bytes(b))

    def byte_vec(self, b: bytes):
        self.u64(len(b))
        self.raw(b)

    def option(self, present: bool):
        self.u8(1 if present else 0)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)

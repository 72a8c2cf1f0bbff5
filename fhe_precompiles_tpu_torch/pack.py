"""Calldata wire format: per-type codecs + offset-prefixed argument framing.

The port's own copy of ``fhe_precompiles_tpu/pack.py``.  Parity target:
the reference's ``src/pack.rs``.

Framing (all offsets are u32 big-endian, pack.rs:11):

* one argument   (pack.rs:119-131):  ``[a]``
* two arguments  (pack.rs:133-151):  ``[u32 off1][a][b]`` with off1 = 4+len(a)
* nullary        (pack.rs:185-199):  ``[public_key]``
* binary op      (pack.rs:208-231):  ``[u32 off1][u32 off2][public_key][a][b]``
  with off1 = 8+len(pk), off2 = off1+len(a)

Scalar encodings (pack.rs:47-117): Unsigned64 -> 8-byte big-endian; Unsigned256
-> 32-byte BE; Signed -> i64 BE; Fractional<64> -> IEEE-754 f64 BE bits;
Vec<u8> -> identity.
"""
from __future__ import annotations

import struct
from typing import Any, Protocol, Tuple

from .errors import FheError, invalid_encoding, unexpected_eof

_INDEX_SIZE = 4  # u32 offsets (pack.rs:11)


class Codec(Protocol):
    """Byte codec for one argument type (the FHESerialize trait, pack.rs:13-19)."""

    def serialize(self, value: Any) -> bytes: ...

    def deserialize(self, data: bytes) -> Any: ...


class U64Codec:
    """Unsigned64 <-> 8-byte big-endian (pack.rs:47-59)."""

    def serialize(self, value: int) -> bytes:
        if not 0 <= value < 1 << 64:
            raise invalid_encoding(f"u64 out of range: {value}")
        return value.to_bytes(8, "big")

    def deserialize(self, data: bytes) -> int:
        if len(data) != 8:
            raise invalid_encoding(f"u64 needs 8 bytes, got {len(data)}")
        return int.from_bytes(data, "big")


class U256Codec:
    """Unsigned256 <-> 32-byte big-endian (pack.rs:61-73)."""

    def serialize(self, value: int) -> bytes:
        if not 0 <= value < 1 << 256:
            raise invalid_encoding(f"u256 out of range: {value}")
        return value.to_bytes(32, "big")

    def deserialize(self, data: bytes) -> int:
        if len(data) != 32:
            raise invalid_encoding(f"u256 needs 32 bytes, got {len(data)}")
        return int.from_bytes(data, "big")


class I64Codec:
    """Signed <-> i64 big-endian two's complement (pack.rs:76-89)."""

    def serialize(self, value: int) -> bytes:
        if not -(1 << 63) <= value < 1 << 63:
            raise invalid_encoding(f"i64 out of range: {value}")
        return value.to_bytes(8, "big", signed=True)

    def deserialize(self, data: bytes) -> int:
        if len(data) != 8:
            raise invalid_encoding(f"i64 needs 8 bytes, got {len(data)}")
        return int.from_bytes(data, "big", signed=True)


class Frac64Codec:
    """Fractional<64> <-> IEEE-754 f64 big-endian bits (pack.rs:91-104)."""

    def serialize(self, value: float) -> bytes:
        return struct.pack(">d", float(value))

    def deserialize(self, data: bytes) -> float:
        if len(data) != 8:
            raise invalid_encoding(f"f64 needs 8 bytes, got {len(data)}")
        return struct.unpack(">d", data)[0]


class BytesCodec:
    """Vec<u8> identity codec (pack.rs:106-117)."""

    def serialize(self, value: bytes) -> bytes:
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        return bytes(data)


class ObjectCodec:
    """Codec for objects exposing to_bytes()/from_bytes() (Ciphertext, PublicKey).

    Mirrors the bincode-delegating impls at pack.rs:21-45.
    """

    def __init__(self, cls):
        self._cls = cls

    def serialize(self, value: Any) -> bytes:
        return value.to_bytes()

    def deserialize(self, data: bytes) -> Any:
        try:
            return self._cls.from_bytes(data)
        except FheError:
            raise
        except Exception as exc:  # malformed payload -> InvalidEncoding
            raise invalid_encoding(str(exc)) from exc


U64 = U64Codec()
U256 = U256Codec()
I64 = I64Codec()
FRAC64 = Frac64Codec()
BYTES = BytesCodec()


# --------------------------------------------------------------------------
# Argument framing
# --------------------------------------------------------------------------

def pack_one_argument(a: Any, ca: Codec) -> bytes:
    """pack.rs:119-124 -- bare payload."""
    return ca.serialize(a)


def unpack_one_argument(data: bytes, ca: Codec) -> Any:
    """pack.rs:126-131."""
    return ca.deserialize(data)


def pack_two_arguments(a: Any, ca: Codec, b: Any, cb: Codec) -> bytes:
    """pack.rs:133-151 -- [u32 BE off1][a][b]."""
    pa = ca.serialize(a)
    pb = cb.serialize(b)
    off1 = _INDEX_SIZE + len(pa)
    if off1 >= 1 << 32:
        raise invalid_encoding("argument too large for u32 offset")
    return off1.to_bytes(4, "big") + pa + pb


def unpack_two_arguments(data: bytes, ca: Codec, cb: Codec) -> Tuple[Any, Any]:
    """pack.rs:153-175."""
    if len(data) < _INDEX_SIZE:
        raise unexpected_eof("two-argument input shorter than offset header")
    off1 = int.from_bytes(data[:_INDEX_SIZE], "big")
    if off1 < _INDEX_SIZE or off1 > len(data):
        raise unexpected_eof(f"offset {off1} out of range for input of {len(data)}")
    a = ca.deserialize(data[_INDEX_SIZE:off1])
    b = cb.deserialize(data[off1:])
    return a, b


def pack_nullary_operation(public_key) -> bytes:
    """pack.rs:185-187 -- bare serialized public key."""
    return public_key.to_bytes()


def unpack_nullary_operation(data: bytes, pk_codec: Codec):
    """pack.rs:197-199."""
    return pk_codec.deserialize(data)


def pack_binary_operation(public_key, a: Any, ca: Codec, b: Any, cb: Codec) -> bytes:
    """pack.rs:208-231 -- [u32 off1][u32 off2][public_key][a][b]."""
    ppk = public_key.to_bytes()
    pa = ca.serialize(a)
    pb = cb.serialize(b)
    off1 = 2 * _INDEX_SIZE + len(ppk)
    off2 = off1 + len(pa)
    if off2 >= 1 << 32:
        raise invalid_encoding("arguments too large for u32 offsets")
    return off1.to_bytes(4, "big") + off2.to_bytes(4, "big") + ppk + pa + pb


def unpack_binary_operation(data: bytes, pk_codec: Codec, ca: Codec,
                            cb: Codec) -> Tuple[Any, Any, Any]:
    """pack.rs:238-266 -- returns (public_key, a, b)."""
    if len(data) < 2 * _INDEX_SIZE:
        raise unexpected_eof("binary-op input shorter than offset header")
    off1 = int.from_bytes(data[:_INDEX_SIZE], "big")
    off2 = int.from_bytes(data[_INDEX_SIZE:2 * _INDEX_SIZE], "big")
    if not (2 * _INDEX_SIZE <= off1 <= off2 <= len(data)):
        raise unexpected_eof(
            f"offsets ({off1},{off2}) out of range for input of {len(data)}")
    pk = pk_codec.deserialize(data[2 * _INDEX_SIZE:off1])
    a = ca.deserialize(data[off1:off2])
    b = cb.deserialize(data[off2:])
    return pk, a, b

"""SEAL 4.x blob codec: headers, parms_id, ciphertext/plaintext/kswitch blobs.

The port's own copy of ``fhe_precompiles_tpu/serialization/seal.py``; its
two zstd calls go through ``zstd_codec`` (``zstandard`` where it imports,
else the machine's libzstd through ctypes).

Layout (reverse-engineered from the reference's key blobs and verified by the
ternary-secret-key oracle of the JAX package's tests):

SEAL stream  = 16-byte header + payload
  header     = magic u16 (0xA15E) | header_size u8 (16) | ver_major u8 |
               ver_minor u8 | compr_mode u8 (0 none, 2 zstd) | reserved u16 |
               total_size u64 (including the header itself)

Ciphertext   = parms_id (32 B) | is_ntt_form u8 | size u64 | n u64 | k u64 |
               scale f64 | correction_factor u64 | DynArray
DynArray     = its own 16-byte SEAL header (compr none) | count u64 | count*u64
Plaintext    = parms_id | coeff_count u64 | scale f64 | DynArray
KSwitchKeys  = parms_id | num_vectors u64 | per vector: len u64 |
               len * (16-byte header + Ciphertext members)

parms_id     = BLAKE2b-256 over LE u64s [scheme_id, n, *coeff_modulus, t]
               (reproduced bit-exactly; scheme_id: bfv=1).
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
import threading
from typing import List, Sequence, Tuple

import numpy as np

from ..errors import invalid_encoding
from . import zstd_codec

MAGIC = 0xA15E
VERSION = (4, 0)
COMPR_NONE = 0
COMPR_ZSTD = 2
HEADER_SIZE = 16

SCHEME_BFV = 1


def compute_parms_id(n: int, moduli: Sequence[int], t: int,
                     scheme: int = SCHEME_BFV) -> bytes:
    words = [scheme, n, *moduli, t]
    buf = b"".join(struct.pack("<Q", w) for w in words)
    return hashlib.blake2b(buf, digest_size=32).digest()


def pack_header(total_size: int, compr_mode: int) -> bytes:
    return struct.pack("<HBBBBHQ", MAGIC, HEADER_SIZE, VERSION[0], VERSION[1],
                       compr_mode, 0, total_size)


def unpack_header(data: bytes, off: int = 0) -> Tuple[int, int]:
    """Returns (total_size, compr_mode)."""
    if len(data) - off < HEADER_SIZE:
        raise invalid_encoding("SEAL header truncated")
    magic, hsz, _maj, _min, compr, _res, size = struct.unpack_from(
        "<HBBBBHQ", data, off)
    if magic != MAGIC or hsz != HEADER_SIZE:
        raise invalid_encoding(f"bad SEAL header magic={magic:#x}")
    return size, compr


# zstd contexts allocate ~MB workspaces; rebuilding one per ciphertext was
# the second-largest byte-path cost after the FHE math itself.  Contexts are
# not safe for concurrent use, so cache them per thread (output bytes are
# unchanged -- same parameters, deterministic encoder).
_zstd_tls = threading.local()


def _zstd_compressor():
    c = getattr(_zstd_tls, "compressor", None)
    if c is None:
        # one-time per process: verify this zstd build reproduces the
        # consensus-canonical frames (builds diverge on sparse-noise
        # ciphertext payloads; a non-canonical build warns -- see
        # zstd_probes.check_python_zstd_canonical)
        from .zstd_probes import check_python_zstd_canonical
        check_python_zstd_canonical()
        c = zstd_codec.compressor()
        _zstd_tls.compressor = c
    return c


def _zstd_decompressor():
    d = getattr(_zstd_tls, "decompressor", None)
    if d is None:
        d = zstd_codec.decompressor()
        _zstd_tls.decompressor = d
    return d


def wrap_stream(payload: bytes, compress: bool = True) -> bytes:
    """Serialize `payload` as a SEAL stream (header + optional zstd)."""
    if compress:
        body = _zstd_compressor().compress(payload)
        mode = COMPR_ZSTD
    else:
        body = payload
        mode = COMPR_NONE
    return pack_header(HEADER_SIZE + len(body), mode) + body


def unwrap_stream(data: bytes) -> bytes:
    """Parse a SEAL stream, returning the decompressed payload."""
    size, compr = unpack_header(data)
    if size != len(data):
        raise invalid_encoding(f"SEAL stream size mismatch {size} != {len(data)}")
    body = data[HEADER_SIZE:]
    if compr == COMPR_ZSTD:
        try:
            return _zstd_decompressor().decompress(
                body, max_output_size=1 << 30)
        except zstd_codec.ZstdError as exc:
            raise invalid_encoding(f"zstd: {exc}") from exc
    if compr == COMPR_NONE:
        return body
    raise invalid_encoding(f"unsupported compression mode {compr}")


def _pack_dynarray(values: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(values, dtype="<u8").reshape(-1)
    inner = struct.pack("<Q", flat.size) + flat.tobytes()
    return pack_header(HEADER_SIZE + len(inner), COMPR_NONE) + inner


def _unpack_dynarray(data: bytes, off: int) -> Tuple[np.ndarray, int]:
    size, compr = unpack_header(data, off)
    if compr != COMPR_NONE:
        raise invalid_encoding("compressed DynArray unsupported")
    count = struct.unpack_from("<Q", data, off + HEADER_SIZE)[0]
    start = off + HEADER_SIZE + 8
    end = start + 8 * count
    if end > len(data):
        raise invalid_encoding("DynArray truncated")
    arr = np.frombuffer(data, dtype="<u8", count=count, offset=start).copy()
    return arr, end


@dataclasses.dataclass
class SealCiphertextBlob:
    """In-memory form of a SEAL Ciphertext / PublicKey data payload."""

    parms_id: bytes
    is_ntt_form: bool
    n: int
    k: int                      # coeff_modulus_size (limbs)
    data: np.ndarray            # uint64 (size, k, n)
    scale: float = 1.0
    correction_factor: int = 1

    @property
    def size(self) -> int:
        return self.data.shape[0]

    def members(self) -> bytes:
        head = self.parms_id + struct.pack(
            "<BQQQdQ", int(self.is_ntt_form), self.size, self.n, self.k,
            self.scale, self.correction_factor)
        return head + _pack_dynarray(self.data)

    @classmethod
    def parse_members(cls, data: bytes, off: int = 0
                      ) -> Tuple["SealCiphertextBlob", int]:
        if len(data) - off < 32 + 1 + 3 * 8 + 8 + 8:
            raise invalid_encoding("ciphertext members truncated")
        parms_id = data[off:off + 32]
        is_ntt, size, n, k, scale, corr = struct.unpack_from(
            "<BQQQdQ", data, off + 32)
        arr, end = _unpack_dynarray(data, off + 32 + 1 + 8 * 3 + 8 + 8)
        if arr.size != size * k * n:
            raise invalid_encoding(
                f"ciphertext data count {arr.size} != {size}*{k}*{n}")
        return cls(parms_id, bool(is_ntt), n, k,
                   arr.reshape(size, k, n), scale, corr), end

    def to_stream(self, compress: bool = True) -> bytes:
        return wrap_stream(self.members(), compress)

    @classmethod
    def from_stream(cls, data: bytes) -> "SealCiphertextBlob":
        payload = unwrap_stream(data)
        blob, end = cls.parse_members(payload)
        if end != len(payload):
            raise invalid_encoding("trailing bytes after ciphertext")
        return blob


@dataclasses.dataclass
class SealPlaintextBlob:
    """SEAL Plaintext payload (the SecretKey wire form)."""

    parms_id: bytes
    data: np.ndarray            # uint64, flat (coeff_count,)
    scale: float = 1.0

    def members(self) -> bytes:
        head = self.parms_id + struct.pack("<Qd", self.data.size, self.scale)
        return head + _pack_dynarray(self.data)

    @classmethod
    def parse_members(cls, data: bytes, off: int = 0
                      ) -> Tuple["SealPlaintextBlob", int]:
        if len(data) - off < 32 + 16:
            raise invalid_encoding("plaintext members truncated")
        parms_id = data[off:off + 32]
        coeff_count, scale = struct.unpack_from("<Qd", data, off + 32)
        arr, end = _unpack_dynarray(data, off + 32 + 16)
        if arr.size != coeff_count:
            raise invalid_encoding("plaintext coeff count mismatch")
        return cls(parms_id, arr, scale), end

    def to_stream(self, compress: bool = True) -> bytes:
        return wrap_stream(self.members(), compress)

    @classmethod
    def from_stream(cls, data: bytes) -> "SealPlaintextBlob":
        payload = unwrap_stream(data)
        blob, end = cls.parse_members(payload)
        if end != len(payload):
            raise invalid_encoding("trailing bytes after plaintext")
        return blob


@dataclasses.dataclass
class SealKSwitchKeysBlob:
    """SEAL KSwitchKeys / RelinKeys payload."""

    parms_id: bytes
    keys: List[List[SealCiphertextBlob]]   # [vector][decomp index]

    def members(self) -> bytes:
        parts = [self.parms_id, struct.pack("<Q", len(self.keys))]
        for vec in self.keys:
            parts.append(struct.pack("<Q", len(vec)))
            for ct in vec:
                inner = ct.members()
                parts.append(pack_header(HEADER_SIZE + len(inner), COMPR_NONE))
                parts.append(inner)
        return b"".join(parts)

    @classmethod
    def parse_members(cls, data: bytes, off: int = 0
                      ) -> Tuple["SealKSwitchKeysBlob", int]:
        if len(data) - off < 40:
            raise invalid_encoding("kswitch members truncated")
        parms_id = data[off:off + 32]
        nvec = struct.unpack_from("<Q", data, off + 32)[0]
        off += 40
        keys = []
        for _ in range(nvec):
            if len(data) - off < 8:
                raise invalid_encoding("kswitch vector count truncated")
            cnt = struct.unpack_from("<Q", data, off)[0]
            off += 8
            vec = []
            for _ in range(cnt):
                _size, compr = unpack_header(data, off)
                if compr != COMPR_NONE:
                    raise invalid_encoding("nested compressed key unsupported")
                blob, off = SealCiphertextBlob.parse_members(
                    data, off + HEADER_SIZE)
                vec.append(blob)
            keys.append(vec)
        return cls(parms_id, keys), off

    def to_stream(self, compress: bool = True) -> bytes:
        return wrap_stream(self.members(), compress)

    @classmethod
    def from_stream(cls, data: bytes) -> "SealKSwitchKeysBlob":
        payload = unwrap_stream(data)
        blob, end = cls.parse_members(payload)
        if end != len(payload):
            raise invalid_encoding("trailing bytes after kswitch keys")
        return blob

"""ctypes binding of the ``fhe_tpu_*`` batched codec in
``_build/libc_fhe_native.so``.

The port's counterpart of ``fhe_precompiles_tpu/native/codec.py``.  The C++
codec in ``precompiles.cpp`` (calldata framing, bincode/SEAL/zstd, plaintext
encodings, wire checks: the decode and encode halves of the reference's byte
contract, c_fhe.rs:8-59) is exposed at the decode/compute boundary, so that
``serve.ByteServer(codec="native")`` runs the host codec in worker threads
(ctypes releases the GIL for every call) while the FHE compute batches on
the card.  Error codes and check order are those of the one-shot path, which
keeps the server byte-equal to ``FheApp.call`` request by request.

What differs from the JAX package's module: nothing here reads the
environment.  The zstd build is an argument (``NativeCodec(app, zstd=...)``,
``NativeCodec.use_zstd``); by default it is the build this process's
``serialization/zstd_codec.py`` compresses with, so that the batched results
(C++) and the per-request fallbacks (python) come from one build.  A build
the library refuses raises :class:`ZstdBuildRefused`; nothing falls back.

The library keeps one state a process: the network keys it was bound to and
the active zstd build are shared by every ``NativeCodec``.
"""
from __future__ import annotations

import ctypes
import importlib.util
from ctypes import (POINTER, byref, c_char_p, c_int32, c_int64, c_size_t,
                    c_uint64, c_uint8, c_void_p)
from typing import Optional, Tuple

import numpy as np

from ..ops import build as _build
from ..serialization import keyio, zstd_codec

_U64P = POINTER(c_uint64)

#: fhe_tpu_use_libzstd's refusals by code
ZSTD_REFUSALS = {1: "dlopen failed", 2: "missing symbols",
                 3: "not consensus-canonical (frame mismatch)"}


class ZstdBuildRefused(ValueError):
    """``fhe_tpu_use_libzstd`` refused a zstd build; ``code`` is its return
    code (``ZSTD_REFUSALS``).  The active build is unchanged."""

    def __init__(self, path: str, code: int):
        super().__init__(f"zstd build {path!r} refused: code {code} "
                         f"({ZSTD_REFUSALS.get(code, 'unknown')})")
        self.path = path
        self.code = code


def process_zstd() -> str:
    """The zstd build ``serialization/zstd_codec.py`` uses in this process,
    as ``NativeCodec`` names it: the path of the ``zstandard`` wheel's
    ``_cffi`` extension (its bundled zstd, with the ``ZSTD_*`` symbols)
    where ``zstandard`` imports, else "system": the ``libzstd.so.1`` the
    library links, which the ctypes codec loads too."""
    if zstd_codec.zstandard is not None:
        spec = importlib.util.find_spec("zstandard._cffi")
        if spec is not None and spec.origin:
            return spec.origin
    return "system"


def load_library() -> ctypes.CDLL:
    """The codec library with the signatures of its ``fhe_tpu_*`` calls,
    built first where its sources changed (``ops/build.py``
    ``build_native_codec``).  Raises if the build or the load fails."""
    lib = ctypes.CDLL(str(_build.build_native_codec()))
    sigs = {
        "fhe_tpu_init_keys": (c_int32, [c_char_p, c_size_t, c_char_p,
                                        c_size_t]),
        "fhe_tpu_params": (c_int32, [POINTER(c_uint64)] * 4),
        "fhe_tpu_use_libzstd": (c_int32, [c_char_p]),
        "fhe_tpu_zstd_canonical": (c_int32, []),
        "fhe_tpu_unpack_binary": (c_int32, [
            c_char_p, c_char_p, c_size_t, _U64P, _U64P, POINTER(c_int32),
            POINTER(c_int32), POINTER(c_uint64), POINTER(c_uint64),
            POINTER(c_void_p)]),
        "fhe_tpu_pk_id": (c_int32, [c_void_p, POINTER(c_uint64)]),
        "fhe_tpu_pk_digest": (c_int32, [c_void_p, POINTER(c_uint8)]),
        "fhe_tpu_pk_relin": (c_int32, [c_void_p, _U64P]),
        "fhe_tpu_pk_data": (c_int32, [c_void_p, _U64P]),
        "fhe_tpu_pk_release": (None, [c_void_p]),
        "fhe_tpu_pack_ciphertext": (c_int32, [_U64P, c_uint64,
                                              POINTER(c_void_p),
                                              POINTER(c_int64)]),
        "fhe_tpu_unpack_encrypt": (c_int32, [c_char_p, c_char_p, c_size_t,
                                             _U64P, POINTER(c_uint8)]),
        "fhe_tpu_unpack_decrypt": (c_int32, [c_char_p, c_size_t, _U64P,
                                             POINTER(c_uint64)]),
        "fhe_tpu_decode_scalar": (c_int32, [c_char_p, _U64P,
                                            POINTER(c_void_p),
                                            POINTER(c_int64)]),
        "fhe_tpu_unpack_reencrypt": (c_int32, [c_char_p, c_size_t, _U64P,
                                               POINTER(c_uint64),
                                               POINTER(c_void_p)]),
        "fhe_tpu_reencrypt_finish": (c_int32, [c_char_p, c_char_p, c_size_t,
                                               _U64P, _U64P,
                                               POINTER(c_uint8)]),
        "fhe_free": (None, [c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


class PkRef:
    """Owned reference to a parsed public key inside the library's LRU.

    ``id`` names the library's cache entry while the reference is held
    (equal ids => byte-identical pk blobs; a key evicted and parsed again
    gets a second entry); ``digest``, the BLAKE2b-256 of the blob, is equal
    for equal bytes and is what requests are grouped by.  Release
    explicitly (idempotent); the finalizer is a backstop."""

    __slots__ = ("_lib", "_handle", "id", "digest")

    def __init__(self, lib, handle: int):
        self._lib = lib
        self._handle = handle
        ident = c_uint64()
        lib.fhe_tpu_pk_id(handle, byref(ident))
        self.id = ident.value
        digest = (c_uint8 * 32)()
        lib.fhe_tpu_pk_digest(handle, digest)
        self.digest = bytes(digest)

    def relin(self, k_ct: int, k_key: int, n: int) -> np.ndarray:
        """The key's (k_ct, 2, k_key, n) relin block (raises if absent)."""
        out = np.empty((k_ct, 2, k_key, n), dtype=np.uint64)
        rc = self._lib.fhe_tpu_pk_relin(self._handle,
                                        out.ctypes.data_as(_U64P))
        if rc:
            raise ValueError(f"fhe_tpu_pk_relin failed: code {rc}")
        return out

    def data(self, k_key: int, n: int) -> np.ndarray:
        """The key's (2, k_key, n) public-key data (NTT form)."""
        out = np.empty((2, k_key, n), dtype=np.uint64)
        rc = self._lib.fhe_tpu_pk_data(self._handle, out.ctypes.data_as(_U64P))
        if rc:
            raise ValueError(f"fhe_tpu_pk_data failed: code {rc}")
        return out

    def release(self) -> None:
        if self._handle:
            self._lib.fhe_tpu_pk_release(self._handle)
            self._handle = 0

    def __del__(self):  # pragma: no cover - GC order dependent
        try:
            self.release()
        except Exception:
            pass


class NativeCodec:
    """Host-side byte codec backed by ``libc_fhe_native.so``.

    Binds the library to the app's network keys (so that its parameter
    checks, seeds and output framing agree with the app exactly), selects
    the zstd build (`zstd`: a library path, "system" for the linked
    ``libzstd.so.1``, None for ``process_zstd()``), then serves
    per-request decode and encode calls."""

    def __init__(self, app, zstd: Optional[str] = None):
        self.lib = lib = load_library()
        self.zstd_source = "system"
        self.use_zstd(zstd if zstd is not None else process_zstd())

        pub = app._public_key_bytes
        pri = keyio.save_private_key(app.private_key)
        rc = lib.fhe_tpu_init_keys(pub, len(pub), pri, len(pri))
        if rc:
            raise RuntimeError(
                f"fhe_tpu_init_keys failed (code {rc}): the native library "
                "is already bound to different network keys in this process")
        n, k_ct, k_key, t = (c_uint64() for _ in range(4))
        lib.fhe_tpu_params(byref(n), byref(k_ct), byref(k_key), byref(t))
        p = app.params
        if (n.value, k_ct.value, k_key.value, t.value) != (
                p.n, len(p.ct_moduli), len(p.key_moduli), p.t):
            raise RuntimeError("native codec params disagree with the app")
        self.n, self.k, self.kk = p.n, len(p.ct_moduli), len(p.key_moduli)

    def use_zstd(self, path: str) -> None:
        """Point the library's zstd dispatch at `path` ("system": the linked
        build, unverified).  Any other build is verified against the
        canonical frames of ``zstd_canonical.h`` first; a refusal raises
        :class:`ZstdBuildRefused` and leaves the active build as it was."""
        rc = self.lib.fhe_tpu_use_libzstd(path.encode())
        if rc:
            raise ZstdBuildRefused(path, rc)
        self.zstd_source = path

    def zstd_canonical(self) -> bool:
        """Whether the active build reproduces the canonical frames."""
        return bool(self.lib.fhe_tpu_zstd_canonical())

    # ------------------------------------------------------------------
    def unpack_binary(self, name: str, data: bytes):
        """Decode a binary-op calldata blob.

        Returns (code, shape, op, ct, other, ct_size, other_size, pk) with
        shape in {"cc", "cp", "pc"} and op in {"add", "sub", "mul"}; ct and
        other are (2, k, n) uint64 arrays (cc) or the ciphertext and the (n,)
        encoded plaintext (cp, pc).  A ciphertext whose size is not 2 is
        valid but not batchable (its array is undefined): route it to the
        one-shot path."""
        k, n = self.k, self.n
        ct = np.empty((2, k, n), dtype=np.uint64)
        other = np.empty((2, k, n), dtype=np.uint64)  # >= (n,) for cp/pc
        shape, op = c_int32(), c_int32()
        ct_size, other_size = c_uint64(), c_uint64()
        handle = c_void_p()
        rc = self.lib.fhe_tpu_unpack_binary(
            name.encode(), data, len(data), ct.ctypes.data_as(_U64P),
            other.ctypes.data_as(_U64P), byref(shape), byref(op),
            byref(ct_size), byref(other_size), byref(handle))
        if rc:
            return rc, None, None, None, None, 0, 0, None
        pk = PkRef(self.lib, handle.value)
        shape_s = ("cc", "cp", "pc")[shape.value]
        op_s = ("add", "sub", "mul")[op.value]
        if shape_s != "cc":
            other = other.reshape(-1)[:n]  # the encoded plaintext poly
        return (0, shape_s, op_s, ct, other, ct_size.value, other_size.value,
                pk)

    def pack_ciphertext(self, data: np.ndarray) -> bytes:
        """(size, k, n) uint64 residues -> serialized ciphertext bytes."""
        arr = np.ascontiguousarray(data, dtype=np.uint64)
        out, out_len = c_void_p(), c_int64()
        rc = self.lib.fhe_tpu_pack_ciphertext(
            arr.ctypes.data_as(_U64P), arr.shape[0], byref(out),
            byref(out_len))
        if rc:
            raise ValueError(f"fhe_tpu_pack_ciphertext failed: code {rc}")
        try:
            return ctypes.string_at(out.value, out_len.value)
        finally:
            self.lib.fhe_free(out)

    def unpack_encrypt(self, tname: str, data: bytes
                       ) -> Tuple[int, Optional[np.ndarray], bytes]:
        """Decode an encrypt_<tname> blob -> (code, (n,) plain, seed64)."""
        m = np.empty(self.n, dtype=np.uint64)
        seed = (c_uint8 * 64)()
        rc = self.lib.fhe_tpu_unpack_encrypt(tname.encode(), data, len(data),
                                             m.ctypes.data_as(_U64P), seed)
        if rc:
            return rc, None, b""
        return 0, m, bytes(seed)

    def unpack_decrypt(self, data: bytes
                       ) -> Tuple[int, Optional[np.ndarray], int]:
        """Decode a decrypt_* blob -> (code, (2, k, n) ct, size)."""
        ct = np.empty((2, self.k, self.n), dtype=np.uint64)
        size = c_uint64()
        rc = self.lib.fhe_tpu_unpack_decrypt(data, len(data),
                                             ct.ctypes.data_as(_U64P),
                                             byref(size))
        if rc:
            return rc, None, 0
        return 0, ct, size.value

    def unpack_reencrypt(self, data: bytes):
        """Decode a reencrypt_* blob -> (code, ct, size, target PkRef)."""
        ct = np.empty((2, self.k, self.n), dtype=np.uint64)
        size = c_uint64()
        handle = c_void_p()
        rc = self.lib.fhe_tpu_unpack_reencrypt(
            data, len(data), ct.ctypes.data_as(_U64P), byref(size),
            byref(handle))
        if rc:
            return rc, None, 0, None
        return 0, ct, size.value, PkRef(self.lib, handle.value)

    def reencrypt_finish(self, tname: str, data: bytes, poly: np.ndarray
                         ) -> Tuple[int, Optional[np.ndarray], bytes]:
        """Decrypted poly -> (code, re-encoded (n,) plain, seed64)."""
        arr = np.ascontiguousarray(poly, dtype=np.uint64)
        m = np.empty(self.n, dtype=np.uint64)
        seed = (c_uint8 * 64)()
        rc = self.lib.fhe_tpu_reencrypt_finish(
            tname.encode(), data, len(data), arr.ctypes.data_as(_U64P),
            m.ctypes.data_as(_U64P), seed)
        if rc:
            return rc, None, b""
        return 0, m, bytes(seed)

    def decode_scalar(self, tname: str, poly: np.ndarray
                      ) -> Tuple[int, bytes]:
        """(n,) mod-t poly -> (code, big-endian scalar bytes)."""
        arr = np.ascontiguousarray(poly, dtype=np.uint64)
        out, out_len = c_void_p(), c_int64()
        rc = self.lib.fhe_tpu_decode_scalar(tname.encode(),
                                            arr.ctypes.data_as(_U64P),
                                            byref(out), byref(out_len))
        if rc:
            return rc, b""
        try:
            return 0, ctypes.string_at(out.value, out_len.value)
        finally:
            self.lib.fhe_free(out)

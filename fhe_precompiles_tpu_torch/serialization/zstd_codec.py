"""The two zstd calls of the SEAL stream codec (``seal.wrap_stream`` /
``seal.unwrap_stream``): compression at a level with the content size
written, and decompression of the first frame of a body.

Through the ``zstandard`` module where it imports, exactly as the JAX
package's ``serialization/seal.py`` calls it.  Where it does not (Python has
no zstd of its own before 3.14), through the machine's ``libzstd.so.1``
bound with ``ctypes``: the library the JAX package's native code links with
``-lzstd``.  The ctypes codec makes the calls ``zstandard`` makes
(``ZSTD_compress2`` with the level and the content-size flag set on the
context; one ``ZSTD_decompressStream`` into a buffer of the frame's stated
size, or of ``max_output_size`` where the frame does not state it; data
after the first frame ignored) and raises :class:`ZstdError` wherever
``zstandard`` raises its own, so the codes and bytes of the precompiles do
not depend on which one runs.  The frames a library emits depend on its
build: ``zstd_probes.check_python_zstd_canonical`` says whether this
process's codec emits the consensus-canonical ones.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading

import numpy as np

try:
    import zstandard
except ImportError:
    zstandard = None

LIBRARY = "libzstd.so.1"

_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_SKIPPABLE_MAGIC = 0x184D2A50           # low four bits: the frame's variant
_C_COMPRESSION_LEVEL = 100              # ZSTD_cParameter
_C_CONTENT_SIZE_FLAG = 200
_RESET_SESSION_ONLY = 1                 # ZSTD_ResetDirective


class LibZstdError(Exception):
    """A failure of the ctypes codec (``zstandard.ZstdError``'s
    counterpart)."""


#: What ``decompress`` raises on a body that is not a valid frame.
ZstdError = zstandard.ZstdError if zstandard is not None else LibZstdError


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """``libzstd.so.1`` with the signatures of the calls used here, loaded on
    first use (importing this module opens no file)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(LIBRARY)
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            sigs = {
                "ZSTD_versionNumber": (ctypes.c_uint, []),
                "ZSTD_isError": (ctypes.c_uint, [size_t]),
                "ZSTD_getErrorName": (ctypes.c_char_p, [size_t]),
                "ZSTD_compressBound": (size_t, [size_t]),
                "ZSTD_createCCtx": (vp, []),
                "ZSTD_freeCCtx": (size_t, [vp]),
                "ZSTD_CCtx_setParameter": (size_t, [vp, ctypes.c_int,
                                                    ctypes.c_int]),
                "ZSTD_CCtx_reset": (size_t, [vp, ctypes.c_int]),
                "ZSTD_compress2": (size_t, [vp, vp, size_t, ctypes.c_char_p,
                                            size_t]),
                "ZSTD_createDCtx": (vp, []),
                "ZSTD_freeDCtx": (size_t, [vp]),
                "ZSTD_DCtx_reset": (size_t, [vp, ctypes.c_int]),
                "ZSTD_getFrameContentSize": (ctypes.c_ulonglong,
                                             [ctypes.c_char_p, size_t]),
                "ZSTD_decompressStream": (size_t, [
                    vp, ctypes.POINTER(_OutBuffer),
                    ctypes.POINTER(_InBuffer)]),
            }
            for name, (restype, argtypes) in sigs.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _check(lib, result: int, what: str) -> int:
    if lib.ZSTD_isError(result):
        raise LibZstdError(
            f"{what}: {lib.ZSTD_getErrorName(result).decode()}")
    return result


class LibCompressor:
    """``zstandard.ZstdCompressor(level=level, write_content_size=True)``
    over libzstd; not safe for concurrent use (one a thread)."""

    def __init__(self, level: int = 3):
        self._lib = lib = load_library()
        self._cctx = lib.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx")
        _check(lib, lib.ZSTD_CCtx_setParameter(
            self._cctx, _C_COMPRESSION_LEVEL, level), "compression level")
        _check(lib, lib.ZSTD_CCtx_setParameter(
            self._cctx, _C_CONTENT_SIZE_FLAG, 1), "content size flag")

    def __del__(self):
        if getattr(self, "_cctx", None):
            self._lib.ZSTD_freeCCtx(self._cctx)

    def compress(self, data: bytes) -> bytes:
        lib = self._lib
        data = bytes(data)
        lib.ZSTD_CCtx_reset(self._cctx, _RESET_SESSION_ONLY)
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = _check(lib, lib.ZSTD_compress2(self._cctx, out, cap, data,
                                           len(data)), "cannot compress")
        return out.raw[:n]


class LibDecompressor:
    """``zstandard.ZstdDecompressor()`` over libzstd, its ``decompress``
    with the same outcomes; not safe for concurrent use (one a thread)."""

    def __init__(self):
        self._lib = lib = load_library()
        self._dctx = lib.ZSTD_createDCtx()
        if not self._dctx:
            raise MemoryError("ZSTD_createDCtx")

    def __del__(self):
        if getattr(self, "_dctx", None):
            self._lib.ZSTD_freeDCtx(self._dctx)

    def _content_size(self, data: bytes) -> int:
        """The frame's stated size, _CONTENTSIZE_UNKNOWN where it states
        none; a skippable frame's size is its payload's (as zstandard's
        frame-header read gives it)."""
        if (len(data) >= 4
                and struct.unpack_from("<I", data)[0] & ~0xF
                == _SKIPPABLE_MAGIC):
            if len(data) < 8:
                raise LibZstdError("error determining content size from "
                                   "frame header")
            return struct.unpack_from("<I", data, 4)[0]
        size = self._lib.ZSTD_getFrameContentSize(data, len(data))
        if size == _CONTENTSIZE_ERROR:
            raise LibZstdError("error determining content size from frame "
                               "header")
        return size

    def decompress(self, data: bytes, max_output_size: int = 0) -> bytes:
        lib = self._lib
        data = bytes(data)
        lib.ZSTD_DCtx_reset(self._dctx, _RESET_SESSION_ONLY)
        stated = self._content_size(data)
        if stated == 0:
            return b""
        if stated == _CONTENTSIZE_UNKNOWN:
            if not max_output_size:
                raise LibZstdError("could not determine content size in "
                                   "frame header")
            capacity, stated = max_output_size, 0
        else:
            capacity = stated
        # np.empty: pages are touched only where the frame writes, so a
        # forged size costs address space, not memory
        out = np.empty(capacity, dtype=np.uint8)
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        outb = _OutBuffer(out.ctypes.data, capacity, 0)
        left = _check(lib, lib.ZSTD_decompressStream(
            self._dctx, ctypes.byref(outb), ctypes.byref(inb)),
            "decompression error")
        if left:
            raise LibZstdError("decompression error: did not decompress "
                               "full frame")
        if stated and outb.pos != stated:
            raise LibZstdError(f"decompression error: decompressed "
                               f"{outb.pos} bytes; expected {stated}")
        return out[:outb.pos].tobytes()


def compressor(level: int = 3):
    """A new compressor at `level` that writes the content size."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level, write_content_size=True)
    return LibCompressor(level)


def decompressor():
    """A new decompressor (``.decompress(data, max_output_size)``)."""
    if zstandard is not None:
        return zstandard.ZstdDecompressor()
    return LibDecompressor()


def zstd_version() -> tuple:
    """The version of the zstd library this process compresses with."""
    if zstandard is not None:
        return tuple(zstandard.ZSTD_VERSION)
    v = load_library().ZSTD_versionNumber()
    return (v // 10000, v // 100 % 100, v % 100)


def codec_name() -> str:
    """Which codec runs, with the zstd it compresses with: "zstandard
    0.25.0, zstd 1.5.7" or "libzstd.so.1 (ctypes), zstd 1.5.5"."""
    version = ".".join(map(str, zstd_version()))
    if zstandard is not None:
        return f"zstandard {zstandard.__version__}, zstd {version}"
    return f"{LIBRARY} (ctypes), zstd {version}"


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def library_path() -> str:
    """The resolved path of the ``libzstd.so.1`` the ctypes codec loads
    (the build the port's C++ libraries link by that name), from the
    dynamic loader's ``dladdr`` of one of its functions."""
    fn = load_library().ZSTD_versionNumber
    dladdr = ctypes.CDLL(None).dladdr
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    dladdr.restype = ctypes.c_int
    info = _DlInfo()
    if not dladdr(ctypes.cast(fn, ctypes.c_void_p), ctypes.byref(info)) \
            or not info.dli_fname:
        raise RuntimeError(f"dladdr found no file for {LIBRARY}")
    return os.path.realpath(info.dli_fname.decode())

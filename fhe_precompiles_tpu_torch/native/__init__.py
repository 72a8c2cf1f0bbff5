"""The C ABI of the port: build helpers, the app the shim serves, and a
ctypes view.

Two libraries export the reference's 51 extern-C symbols (49 ``c_fhe_*``
precompiles plus ``fhe_free`` and ``fhe_error``, declared in ``c_fhe.h``),
and the library a host links names the device; neither falls back to the
other:

* ``libc_fhe.so`` (``c_fhe.cpp``, built by ``build``): every call enters
  the embedded interpreter and reaches ``_abi_call`` below, which runs the
  app ``use_app`` named, by default ``testnet.one.FHE``: the torch engine
  on the card.  Without a card every call returns 7.
* ``libc_fhe_cpu.so`` (``build_cpu``; static form ``libc_fhe_cpu.a``):
  ``precompiles.cpp`` over the C++ host engine ``host_engine.cpp``, no
  Python, computed on the CPU.  It also exports ``fhe_tpu_init_keys``,
  ``fhe_tpu_use_libzstd`` and ``fhe_tpu_zstd_canonical``, by which a host
  names its network keys (else the package's ``data/`` keys, found
  relative to the library) and its zstd build.

A node links either; the ctypes view ``NativeFhe`` loads either, for the
tests and ``chip_smoke.py``.

``libc_fhe_native.so`` (the same two sources, copies of the JAX package's
that read no environment variable) is the C++ codec: it exports only the
``fhe_tpu_*`` extension (and ``fhe_free``) that
``serve.ByteServer(codec="native")`` drives through ``codec.NativeCodec``;
the 51 symbols it also holds stay local (``codec_exports.map``).
``engine.NativeEngine`` binds ``libhost_engine.so``, the engine alone:
``FheApp(engine="native")``.  ``ops/build.py`` builds all of them with g++.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

from ..ops import build as _build

NATIVE_DIR = Path(__file__).resolve().parent
LIB_PATH = _build.C_ABI_LIB
# the C host's builds: the library it links -> its executable
HOST_TESTS = {"card": _build.BUILD_DIR / "host_test",
              "cpu": _build.BUILD_DIR / "host_test_cpu",
              "cpu_static": _build.BUILD_DIR / "host_test_cpu_static"}

# the app the shim serves; None: testnet.one.FHE.  One a process, as the
# C ABI itself is.
_app = None


def use_app(app) -> None:
    """Name the app (an ``FheApp``) that every later ABI call in this
    process runs; None restores the default, ``testnet.one.FHE``."""
    global _app
    _app = app


def current_app():
    """The app ABI calls run: the one ``use_app`` named, else
    ``testnet.one.FHE`` (built at first use; raises without a card)."""
    if _app is not None:
        return _app
    from ..testnet import one
    return one.FHE


def _abi_call(name: str, data: bytes) -> Tuple[int, bytes]:
    """What the shim calls for every precompile.  An exception (no card for
    the default app) becomes code 7 in the shim."""
    return current_app().call(name, data)


def build() -> str:
    """Compile ``_build/libc_fhe.so`` unless it is up to date; returns its
    path."""
    return str(_build.build_c_abi())


def build_cpu() -> str:
    """Compile ``_build/libc_fhe_cpu.so`` and ``_build/libc_fhe_cpu.a``
    unless they are up to date; returns the shared library's path."""
    return str(_build.build_native_cpu())


def host_test_command(link: str, out: Path) -> list:
    """The gcc command that builds ``host_test.c`` into `out` against the
    library `link` names: "card" (``-lc_fhe``), "cpu" (``-lc_fhe_cpu``)
    or "cpu_static" (``libc_fhe_cpu.a`` and what it needs); the shared
    links carry an rpath to ``_build/``."""
    d = _build.BUILD_DIR
    cmd = ["gcc", "-O2", "-Wall", str(NATIVE_DIR / "host_test.c"),
           "-I", str(NATIVE_DIR), "-o", str(out)]
    if link == "card":
        return cmd + [f"-L{d}", "-lc_fhe", "-lpthread", f"-Wl,-rpath,{d}"]
    cmd.append("-DFHE_CPU_LIBRARY")
    if link == "cpu":
        return cmd + [f"-L{d}", "-lc_fhe_cpu", "-lpthread",
                      f"-Wl,-rpath,{d}"]
    return cmd + [str(_build.NATIVE_CPU_STATIC), "-l:libzstd.so.1", "-ldl",
                  "-lpthread", "-lstdc++", "-lm"]


def build_host_test(link: str = "card") -> str:
    """Compile ``host_test.c`` against the library `link` names
    (``host_test_command``), built first, into ``HOST_TESTS[link]``
    unless it is up to date; returns its path."""
    if link not in HOST_TESTS:
        raise ValueError(f"unknown link {link!r} (expected one of "
                         f"{sorted(HOST_TESTS)})")
    lib = build() if link == "card" else build_cpu()
    if link == "cpu_static":
        lib = str(_build.NATIVE_CPU_STATIC)
    return str(_build.stamped(
        HOST_TESTS[link], [NATIVE_DIR / "host_test.c",
                           NATIVE_DIR / "c_fhe.h", Path(lib)],
        functools.partial(host_test_command, link)))


class NativeFhe:
    """ctypes view of the C ABI (for tests and Python-hosted callers), by
    default ``libc_fhe.so``, or the library at `path` (``build_cpu()``).
    Loaded into this interpreter, the shim runs ``current_app()``; the CPU
    library computes on its own, and ``init_keys`` and ``use_zstd`` hand it
    its network keys and its zstd build."""

    def __init__(self, path: Optional[str] = None):
        self.lib = ctypes.CDLL(path or build())
        self.lib.fhe_free.argtypes = [ctypes.c_void_p]
        self.lib.fhe_free.restype = None
        self.lib.fhe_error.argtypes = [ctypes.c_int32]
        self.lib.fhe_error.restype = ctypes.c_void_p
        self._fns = {}

    def _fn(self, name: str):
        fn = self._fns.get(name)
        if fn is None:
            fn = getattr(self.lib, f"c_fhe_{name}")
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int64)]
            fn.restype = ctypes.c_int32
            self._fns[name] = fn
        return fn

    def call(self, name: str, data: bytes) -> Tuple[int, bytes]:
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        code = self._fn(name)(data, len(data), ctypes.byref(out),
                              ctypes.byref(out_len))
        payload = b""
        if out.value:
            if code == 0:
                payload = ctypes.string_at(out.value, out_len.value)
            self.lib.fhe_free(out)
        return code, payload

    def error_str(self, code: int) -> str:
        ptr = self.lib.fhe_error(code)
        try:
            return ctypes.string_at(ptr).decode()
        finally:
            self.lib.fhe_free(ptr)

    def init_keys(self, pub: bytes, pri: bytes) -> None:
        """Bind the CPU library to these network key blobs (the
        ``keyio`` format) before its first call; raises if it refuses them
        (code 3: it is bound to other keys already)."""
        fn = self.lib.fhe_tpu_init_keys
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                       ctypes.c_size_t]
        fn.restype = ctypes.c_int32
        code = fn(pub, len(pub), pri, len(pri))
        if code:
            raise RuntimeError(f"fhe_tpu_init_keys: code {code}")

    def use_zstd(self, path: str) -> None:
        """Point the CPU library's zstd calls at the build `path` ("system":
        the linked ``libzstd.so.1``); any other build is verified against
        the canonical frames first.  A refusal raises
        ``codec.ZstdBuildRefused`` and leaves the active build as it
        was."""
        from .codec import ZstdBuildRefused
        fn = self.lib.fhe_tpu_use_libzstd
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int32
        code = fn(path.encode())
        if code:
            raise ZstdBuildRefused(path, code)

    def zstd_canonical(self) -> bool:
        """Whether the CPU library's active zstd build reproduces the
        canonical frames."""
        fn = self.lib.fhe_tpu_zstd_canonical
        fn.argtypes = []
        fn.restype = ctypes.c_int32
        return bool(fn())

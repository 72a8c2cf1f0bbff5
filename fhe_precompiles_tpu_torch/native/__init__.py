"""The C ABI of the port: build helpers, the app the shim serves, and a
ctypes view.

``libc_fhe.so`` (``c_fhe.cpp``, ``c_fhe.h``) exposes the reference's 51
extern-C symbols: 49 ``c_fhe_*`` precompiles plus ``fhe_free`` and
``fhe_error``.  Every call enters the embedded interpreter and reaches
``_abi_call`` below, which runs the app ``use_app`` named, by default
``testnet.one.FHE``: the torch engine on the card.  A node links the
library; the ctypes view ``NativeFhe`` exists for the tests and
``chip_smoke.py``.

``libc_fhe_native.so`` (``precompiles.cpp`` over ``host_engine.cpp``,
copies of the JAX package's sources that read no environment variable) is
the C++ codec: it exports only the ``fhe_tpu_*`` extension (and
``fhe_free``) that ``serve.ByteServer(codec="native")`` drives through
``codec.NativeCodec``; the 51 symbols it also compiles stay local, so the
library above remains the one C entry point (``ops/build.py``
``build_native_codec`` builds it with g++ and ``codec_exports.map``).
The port's engine over that library (the JAX package's
``native/engine.py``) is not ported yet.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Tuple

from ..ops import build as _build

NATIVE_DIR = Path(__file__).resolve().parent
LIB_PATH = _build.C_ABI_LIB
HOST_TEST = _build.BUILD_DIR / "host_test"

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


def build_host_test() -> str:
    """Compile ``host_test.c`` against the library into ``_build/host_test``
    (rpath: the library's directory); returns its path."""
    lib = Path(build())
    cmd = ["gcc", "-O2", "-Wall", str(NATIVE_DIR / "host_test.c"),
           "-I", str(NATIVE_DIR), "-o", str(HOST_TEST), f"-L{lib.parent}",
           "-lc_fhe", "-lpthread", f"-Wl,-rpath,{lib.parent}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("gcc failed:\n" + " ".join(cmd) + "\n"
                           + proc.stdout + proc.stderr)
    return str(HOST_TEST)


class NativeFhe:
    """ctypes view of the C ABI (for tests and Python-hosted callers).
    Loaded into this interpreter, the shim runs ``current_app()``."""

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

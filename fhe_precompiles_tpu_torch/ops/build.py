"""Builds the CUDA sources under ``csrc/`` into one shared library and loads
it with ``ctypes``; builds the C ABI shim (``native/c_fhe.cpp``) with the
host's C++ compiler.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into
``fhe_precompiles_tpu_torch/_build/`` at first use; the file name carries a
hash of the sources, so an edited source is rebuilt and an unchanged one is
reused.  The library has a plain C interface (no PyTorch headers, a build of
seconds); pointers and the stream cross as ``c_void_p``.

Nothing here runs when the module is imported: a machine without ``nvcc``
can import the package and use the CPU path.  ``load_library`` raises there.

``build_c_abi`` compiles ``native/c_fhe.cpp`` (no nvcc: g++ with the running
interpreter's headers, linked to its ``libpython`` as the JAX package's
``native/Makefile`` does) into ``_build/libc_fhe.so``, a stable name a C
host links with ``-lc_fhe``; a hash of the sources and flags beside it says
when to build again.

``build_native_objects`` compiles ``native/precompiles.cpp`` and
``native/host_engine.cpp`` (the C++ codec and host engine, no Python) with
g++ into ``_build/precompiles.o`` and ``_build/host_engine.o``, once for
every library linked from them:

* ``build_native_codec``: ``_build/libc_fhe_native.so``, which exports the
  ``fhe_tpu_*`` codec calls and ``fhe_free`` alone
  (``native/codec_exports.map``);
* ``build_native_cpu``: ``_build/libc_fhe_cpu.so``, the 51 symbols of the
  C ABI computed on the CPU (``native/cpu_exports.map``), and its static
  form ``_build/libc_fhe_cpu.a``;
* ``build_host_engine``: ``_build/libhost_engine.so``, the engine's
  ``he_*`` calls (``native/engine.py``).

``build_sanitized_objects`` compiles the same two sources once for each
instrumentation of ``SANITIZERS`` into ``_build/sanitize/``: "asan"
(AddressSanitizer and UndefinedBehaviorSanitizer, with gcc's
``-fsanitize-coverage=trace-pc`` edges, shared by the coverage fuzzer and
the ASan drive) and "tsan" (ThreadSanitizer); ``build_sanitized`` links
one of the port's C or C++ drivers against such a set
(``native/fuzz.py``, ``native/sanitize.py``).

Each output has a stamp (a hash of its inputs and its command) and a lock
beside it.  The libraries link libzstd by its runtime name,
``-l:libzstd.so.1``, and ``precompiles.cpp`` declares the calls it makes in
``native/zstd_decls.h``: the card's machine has the library but neither
``zstd.h`` nor the ``libzstd.so`` link name, so the build is the same on
every machine.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"
# the shim strips three components of its own path (libc_fhe.so, _build/,
# the package directory) to find the repository root
C_ABI_LIB = BUILD_DIR / "libc_fhe.so"
# the C++ libraries strip two components of their own path (the library,
# _build/) to find the package's data/ directory
NATIVE_CODEC_LIB = BUILD_DIR / "libc_fhe_native.so"
NATIVE_CPU_LIB = BUILD_DIR / "libc_fhe_cpu.so"
NATIVE_CPU_STATIC = BUILD_DIR / "libc_fhe_cpu.a"
HOST_ENGINE_LIB = BUILD_DIR / "libhost_engine.so"
NATIVE_CODEC_SOURCES = ("precompiles.cpp", "host_engine.cpp", "c_fhe.h",
                        "zstd_canonical.h", "zstd_decls.h",
                        "codec_exports.map")
# object -> its source and the headers of the port that source includes
NATIVE_OBJECTS = {
    "precompiles.o": ("precompiles.cpp", "c_fhe.h", "zstd_canonical.h",
                      "zstd_decls.h"),
    "host_engine.o": ("host_engine.cpp",),
}
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17"]
SANITIZE_DIR = BUILD_DIR / "sanitize"
# instrumentation -> its compile flags, and what a link against it adds.
# The asan objects carry trace-pc edges: a binary that links them defines
# __sanitizer_cov_trace_pc (the fuzzer's bitmap, or an empty one).
_ASAN = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
SANITIZERS = {
    "asan": (["-O1", "-g", "-fPIC", "-std=c++17", *_ASAN,
              "-fsanitize-coverage=trace-pc"], _ASAN),
    "tsan": (["-O1", "-g", "-fPIC", "-std=c++17", "-fsanitize=thread"],
             ["-fsanitize=thread"]),
}
# what every binary linked from the C++ objects needs beside them
NATIVE_LINK = ["-l:libzstd.so.1", "-ldl", "-lpthread"]

# --threads 0: the sources are compiled side by side, one job for each
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--threads", "0"]

_lib = None
build_seconds = None        # wall time of the nvcc run, None if reused


def _find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of fhe_precompiles_tpu_torch are "
        "built from csrc/ at first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _set_argtypes(lib) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fhe_tail_params_size.argtypes = []
    lib.fhe_tail_params_size.restype = i
    lib.fhe_tail_limits.argtypes = [ctypes.POINTER(i)]
    lib.fhe_tail_limits.restype = None
    lib.fhe_tail_to_bsk_ext.argtypes = [vp, vp, ll, i, vp, vp]
    lib.fhe_tail_dyadic.argtypes = [vp, vp, vp, ll, i, vp, vp]
    lib.fhe_tail_floor_sk.argtypes = [vp, vp, ll, i, vp, vp]
    lib.fhe_tail_relin_dot.argtypes = [vp, vp, vp, ll, i, vp, vp]
    lib.fhe_tail_mod_down.argtypes = [vp, vp, vp, ll, i, ll, vp, vp]
    for name in ("to_bsk_ext", "dyadic", "floor_sk", "relin_dot", "mod_down"):
        getattr(lib, "fhe_tail_" + name).restype = i
    # ntt.cu: in, out, rows, L, n, group stride, moduli, twiddles, their
    # Shoup words, (inverse only: n_inv and its Shoup word,) stream
    lib.fhe_ntt_max_n.argtypes = []
    lib.fhe_ntt_max_n.restype = i
    lib.fhe_ntt_forward.argtypes = [vp, vp, ll, i, i, ll, vp, vp, vp, vp]
    lib.fhe_ntt_forward.restype = i
    lib.fhe_ntt_inverse.argtypes = [vp, vp, ll, i, i, ll, vp, vp, vp, vp, vp,
                                    vp]
    lib.fhe_ntt_inverse.restype = i
    # four_step.cu: in, out, rows, L, R, C, group stride, fold scalars, the
    # r- and c-product weights (packed), grid and its beta = 40 Shoup words,
    # inverse, stream; the batch geometry at R, C
    lib.fhe_four_step_ntt.argtypes = [vp, vp, ll, i, i, i, ll, vp, vp, vp, vp,
                                      vp, i, vp]
    lib.fhe_four_step_ntt.restype = i
    lib.fhe_four_step_fit.argtypes = [i, i, ctypes.POINTER(i)]
    lib.fhe_four_step_fit.restype = None
    # in, out, rows, L, K, J, group stride, fold scalars, packed weights,
    # grid words (None for mode 0), mode, stream; the batch geometry at K, J
    lib.fhe_four_step_phase.argtypes = [vp, vp, ll, i, i, i, ll, vp, vp, vp,
                                        i, vp]
    lib.fhe_four_step_phase.restype = i
    lib.fhe_four_step_phase_fit.argtypes = [i, i, ctypes.POINTER(i)]
    lib.fhe_four_step_phase_fit.restype = None


def load_library(verbose: bool = False):
    """The loaded kernel library; builds it first if this source state has
    no build yet.  Raises if there is no ``nvcc`` or the build fails."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    cu, cuh = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libfhe_kernels_{h.hexdigest()[:16]}.so"
    if not so.is_file():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _set_argtypes(lib)
    _lib = lib
    return lib


def stamped(out: Path, inputs, command) -> Path:
    """Runs ``command(tmp)`` and renames ``tmp`` to `out`, unless the stamp
    beside `out` (``<name>.sha256``) holds the hash of the `inputs` (files)
    and of ``command(out)``; returns `out`.  Processes that build at once
    take turns (a lock file beside it).  Raises if the command fails."""
    h = hashlib.sha256()
    for f in inputs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(command(out)).encode())
    digest = h.hexdigest()
    stamp = out.with_name(out.name + ".sha256")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file() and stamp.is_file() and stamp.read_text() == digest:
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        tmp.unlink(missing_ok=True)     # ar adds to an archive it finds
        cmd = command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, out)
        stamp.write_text(digest)
    return out


def c_abi_command(out: Path) -> list:
    """The g++ command that builds the shim into `out`, linked to the
    running interpreter's shared ``libpython`` (a standalone C host then
    starts its own interpreter; loaded into this one, the shim uses it)."""
    libdir = sysconfig.get_config_var("LIBDIR")
    return ["g++", "-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17",
            "-shared", "-I", sysconfig.get_config_var("INCLUDEPY"),
            "-I", str(NATIVE), str(NATIVE / "c_fhe.cpp"), "-o", str(out),
            f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{sysconfig.get_config_var('LDVERSION')}", "-ldl"]


def build_c_abi() -> Path:
    """Builds ``_build/libc_fhe.so`` if the sources or the command changed
    since the last build; returns its path.  Raises if g++ fails."""
    return stamped(C_ABI_LIB, [NATIVE / "c_fhe.cpp", NATIVE / "c_fhe.h"],
                   c_abi_command)


def object_command(obj: str, out: Path) -> list:
    """The g++ command that compiles object `obj` (a key of
    ``NATIVE_OBJECTS``) into `out`: the JAX package's Makefile's flags
    without its warnings."""
    return ["g++", *CXX_FLAGS, "-c", str(NATIVE / NATIVE_OBJECTS[obj][0]),
            "-o", str(out)]


def _object(obj: str) -> Path:
    return stamped(BUILD_DIR / obj, [NATIVE / f for f in NATIVE_OBJECTS[obj]],
                   functools.partial(object_command, obj))


def build_native_objects() -> list:
    """Compiles ``precompiles.o`` and ``host_engine.o`` into ``_build/``
    side by side, each unless its stamp is up to date; returns their
    paths.  Every C++ library of the port links from these."""
    with ThreadPoolExecutor(len(NATIVE_OBJECTS)) as pool:
        return list(pool.map(_object, NATIVE_OBJECTS))


def _objects() -> list:
    return [str(BUILD_DIR / obj) for obj in NATIVE_OBJECTS]


def native_codec_command(out: Path) -> list:
    """The g++ command that links the codec library into `out` from the
    two objects.  Its version script exports the ``fhe_tpu_*`` calls and
    ``fhe_free`` only: the ``c_fhe_*`` and ``he_*`` names it holds stay
    local, so that it neither offers a C host a path nor binds to
    ``libc_fhe.so``'s names of the same spelling."""
    return ["g++", "-shared", *_objects(), "-o", str(out), "-l:libzstd.so.1",
            "-ldl", "-Wl,--version-script=" + str(NATIVE
                                                   / "codec_exports.map")]


def build_native_codec() -> Path:
    """Builds ``_build/libc_fhe_native.so`` (the objects first) unless it
    is up to date; returns its path.  Raises if g++ fails."""
    objs = build_native_objects()
    return stamped(NATIVE_CODEC_LIB, objs + [NATIVE / "codec_exports.map"],
                   native_codec_command)


def native_cpu_command(out: Path) -> list:
    """The g++ command that links the CPU library into `out` from the two
    objects; ``native/cpu_exports.map`` exports the reference's 51 symbols
    and the three ``fhe_tpu_*`` calls that name the keys and the zstd
    build, and nothing else."""
    return ["g++", "-shared", *_objects(), "-o", str(out), "-l:libzstd.so.1",
            "-ldl", "-Wl,--version-script=" + str(NATIVE / "cpu_exports.map")]


def build_native_cpu() -> Path:
    """Builds ``_build/libc_fhe_cpu.so`` and its static form
    ``_build/libc_fhe_cpu.a`` (the objects first), each unless it is up to
    date; returns the shared library's path.  Raises if a step fails."""
    objs = build_native_objects()
    stamped(NATIVE_CPU_STATIC, objs,
            lambda out: ["ar", "rcs", str(out), *_objects()])
    return stamped(NATIVE_CPU_LIB, objs + [NATIVE / "cpu_exports.map"],
                   native_cpu_command)


def build_host_engine() -> Path:
    """Builds ``_build/libhost_engine.so``, the C++ engine alone with its
    ``he_*`` calls exported (``native/engine.py`` binds it), from
    ``host_engine.o`` unless it is up to date; returns its path."""
    obj = _object("host_engine.o")
    return stamped(HOST_ENGINE_LIB, [obj],
                   lambda out: ["g++", "-shared", str(obj), "-o", str(out)])


def sanitized_object_command(kind: str, obj: str, out: Path) -> list:
    """The g++ command that compiles object `obj` (a key of
    ``NATIVE_OBJECTS``) with the instrumentation `kind` (a key of
    ``SANITIZERS``) into `out`."""
    return ["g++", *SANITIZERS[kind][0], "-c",
            str(NATIVE / NATIVE_OBJECTS[obj][0]), "-o", str(out)]


def sanitized_objects(kind: str) -> list:
    """The paths of the `kind` objects (built or not)."""
    return [SANITIZE_DIR / obj.replace(".o", f".{kind}.o")
            for obj in NATIVE_OBJECTS]


def build_sanitized_objects(kind: str) -> list:
    """Compiles ``precompiles.cpp`` and ``host_engine.cpp`` with the
    instrumentation `kind` into ``_build/sanitize/`` side by side, each
    unless its stamp is up to date; returns their paths."""
    if kind not in SANITIZERS:
        raise ValueError(f"unknown instrumentation {kind!r} (expected one "
                         f"of {sorted(SANITIZERS)})")

    def one(pair):
        obj, out = pair
        return stamped(out, [NATIVE / f for f in NATIVE_OBJECTS[obj]],
                       functools.partial(sanitized_object_command, kind, obj))

    pairs = list(zip(NATIVE_OBJECTS, sanitized_objects(kind)))
    with ThreadPoolExecutor(len(pairs)) as pool:
        return list(pool.map(one, pairs))


def sanitized_command(kind: str, source: str, out: Path) -> list:
    """The g++ command that compiles the driver `source` (a file of
    ``native/``; a ``.c`` file is compiled as C) with the instrumentation
    `kind`, without coverage edges, and links it against the `kind`
    objects into the executable `out`."""
    lang = ["-x", "c"] if source.endswith(".c") else []
    std = [] if lang else ["-std=c++17"]
    return ["g++", "-O1", "-g", *std, *SANITIZERS[kind][1], "-I", str(NATIVE),
            *lang, str(NATIVE / source), "-x", "none",
            *map(str, sanitized_objects(kind)), "-o", str(out), *NATIVE_LINK]


def build_sanitized(kind: str, source: str, headers=()) -> Path:
    """Builds the driver `source` of ``native/`` (with the `headers` of
    ``native/`` it includes) against the `kind` objects into
    ``_build/sanitize/<stem>`` (the objects first), unless it is up to
    date; returns its path.  Raises if a step fails."""
    objs = build_sanitized_objects(kind)
    out = SANITIZE_DIR / Path(source).stem
    return stamped(out, objs + [NATIVE / f for f in (source, "c_fhe.h",
                                                     *headers)],
                   functools.partial(sanitized_command, kind, source))

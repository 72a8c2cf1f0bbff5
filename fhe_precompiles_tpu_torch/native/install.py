"""The install of the port's pure-C++ C ABI, the counterpart of the JAX
package's ``native/Makefile`` ``install`` target and its ``c_fhe.pc``.

``install(prefix)`` builds ``libc_fhe_cpu.so`` and ``libc_fhe_cpu.a``
(``native.build_cpu()``: the 51 symbols computed on the CPU, no Python) and
lays out::

    PREFIX/include/c_fhe.h
    PREFIX/lib/libc_fhe_cpu.so
    PREFIX/lib/libc_fhe_cpu.a
    PREFIX/lib/pkgconfig/c_fhe.pc
    PREFIX/share/c_fhe/network.pub, network.pri

The library finds the package's keys relative to its own path
(``<library>/../../data``), which an installed copy does not have: a C host
names them through ``fhe_tpu_init_keys``, from the ``keydir`` variable of
``c_fhe.pc``, as ``host_test.c --keys`` does::

    host_test --keys $(pkg-config --variable=keydir c_fhe)/network.pub \\
                     $(pkg-config --variable=keydir c_fhe)/network.pri

Link dynamically with ``pkg-config --cflags --libs c_fhe``, or statically
with ``pkg-config --static --cflags --libs c_fhe`` and the archive named as
``-l:libc_fhe_cpu.a`` (a plain ``-lc_fhe_cpu`` picks the ``.so``).
``libc_fhe.so``, the card's shim with its embedded interpreter, is not
installed, as the reference's install leaves its ``libc_fhe.so`` out.

    python -m fhe_precompiles_tpu_torch.native.install --prefix DIR
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

from .. import __version__
from ..ops import build as _build

NATIVE_DIR = Path(__file__).resolve().parent
DATA_DIR = NATIVE_DIR.parent / "data"
PC_NAME = "c_fhe"
# what a link of the shared library needs, and what a static link adds
LIBS = "-lc_fhe_cpu -l:libzstd.so.1 -ldl -lpthread"
LIBS_PRIVATE = "-lstdc++ -lm"


def pc_text(prefix: Path) -> str:
    """The text of ``c_fhe.pc`` for an install at `prefix`."""
    return (f"prefix={prefix}\n"
            "libdir=${prefix}/lib\n"
            "includedir=${prefix}/include\n"
            "keydir=${prefix}/share/c_fhe\n\n"
            f"Name: {PC_NAME}\n"
            "Description: FHE precompiles of fhe_precompiles_tpu_torch, the "
            "51-symbol C ABI computed on the CPU\n"
            f"Version: {__version__}\n"
            f"Libs: -L${{libdir}} {LIBS}\n"
            f"Libs.private: {LIBS_PRIVATE}\n"
            "Cflags: -I${includedir}\n")


def install(prefix) -> dict:
    """Builds the CPU library (unless it is up to date) and installs it
    with its header, its static form, the network keys and ``c_fhe.pc``
    under `prefix` (made if missing).  Returns the installed files by
    role."""
    prefix = Path(prefix).resolve()
    lib = Path(_build.build_native_cpu())
    files = {
        "header": (NATIVE_DIR / "c_fhe.h", prefix / "include" / "c_fhe.h"),
        "shared": (lib, prefix / "lib" / lib.name),
        "static": (_build.NATIVE_CPU_STATIC,
                   prefix / "lib" / _build.NATIVE_CPU_STATIC.name),
        "public_key": (DATA_DIR / "network.pub",
                       prefix / "share" / "c_fhe" / "network.pub"),
        "private_key": (DATA_DIR / "network.pri",
                        prefix / "share" / "c_fhe" / "network.pri"),
    }
    for src, dst in files.values():
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)
    (prefix / "lib" / "libc_fhe_cpu.so").chmod(0o755)
    pc = prefix / "lib" / "pkgconfig" / f"{PC_NAME}.pc"
    pc.parent.mkdir(parents=True, exist_ok=True)
    pc.write_text(pc_text(prefix))
    out = {role: str(dst) for role, (_src, dst) in files.items()}
    out["pkgconfig"] = str(pc)
    return out


def pkg_config(prefix, *args: str) -> str:
    """Runs ``pkg-config`` on the ``c_fhe.pc`` installed at `prefix` (its
    directory as the only ``PKG_CONFIG_PATH``); returns its output.
    Raises if ``pkg-config`` is missing or fails."""
    exe = shutil.which("pkg-config")
    if exe is None:
        raise FileNotFoundError("pkg-config not found: the installed C ABI "
                                "is linked through it")
    pcdir = Path(prefix).resolve() / "lib" / "pkgconfig"
    proc = subprocess.run([exe, *args, PC_NAME], capture_output=True,
                          text=True, env={"PKG_CONFIG_PATH": str(pcdir)})
    if proc.returncode != 0:
        raise RuntimeError(f"pkg-config {' '.join(args)} {PC_NAME}: exit "
                           f"{proc.returncode}\n{proc.stderr}")
    return proc.stdout.strip()


def build_host(prefix, out, static: bool) -> Path:
    """Builds ``host_test.c`` into `out` against the install at `prefix`,
    its flags from ``pkg-config``: the shared library (with an rpath to
    the install's ``lib/``) or, with `static`, the archive and what it
    needs; returns its path.  Raises if gcc fails."""
    cflags = pkg_config(prefix, "--cflags").split()
    if static:
        libs = pkg_config(prefix, "--static", "--libs").split()
        libs = ["-l:libc_fhe_cpu.a" if f == "-lc_fhe_cpu" else f
                for f in libs]
    else:
        libs = pkg_config(prefix, "--libs").split()
        libs.append("-Wl,-rpath," + pkg_config(prefix, "--variable=libdir"))
    cmd = ["gcc", "-O2", "-Wall", "-DFHE_CPU_LIBRARY",
           str(NATIVE_DIR / "host_test.c"), *cflags, "-o", str(out), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("gcc failed:\n" + " ".join(cmd) + "\n"
                           + proc.stdout + proc.stderr)
    return Path(out)


def host_keys(prefix) -> list:
    """The ``--keys`` arguments of a host of the install at `prefix`, from
    ``c_fhe.pc``'s ``keydir``."""
    keydir = pkg_config(prefix, "--variable=keydir")
    return ["--keys", f"{keydir}/network.pub", f"{keydir}/network.pri"]


def main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fhe_precompiles_tpu_torch.native.install",
        description="Install the port's C ABI computed on the CPU "
                    "(libc_fhe_cpu.so / .a, c_fhe.h, c_fhe.pc, the network "
                    "keys) under a prefix.")
    parser.add_argument("--prefix", required=True)
    args = parser.parse_args(argv)
    print(json.dumps(install(args.prefix), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The install of the port's C ABI (``native/install.py``), the counterpart
of the JAX package's ``make install`` with ``c_fhe.pc``, and the clean
install of the package (the counterpart of the JAX package's CI job
``install``, ``.github/workflows/ci.yml``).

``install(prefix)`` lays out the header, ``libc_fhe_cpu.so`` and ``.a``,
the network keys and ``c_fhe.pc``; ``host_test.c`` linked through
``pkg-config`` against the installed shared library and, statically,
against the archive passes with ``--keys`` from ``keydir``.  The clean
install copies the two packages with ``pyproject.toml``, ``README.md`` and
``LICENSE`` into a temporary directory, installs them into a new virtual
environment with pip (no index, no build isolation), and from a directory
outside the repository imports the port, builds its CPU library inside the
installed package and runs one encrypt and decrypt through it, byte-equal
to the port's golden ``FheApp``.
"""
import json
import shutil
import site
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import __version__, native
from fhe_precompiles_tpu_torch.native import install as inst
from fhe_precompiles_tpu_torch.ops import build
from helpers import bounded

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefix")
    return root, inst.install(root)


def test_install_lays_out_the_files(prefix):
    root, files = prefix
    want = {"header": "include/c_fhe.h", "shared": "lib/libc_fhe_cpu.so",
            "static": "lib/libc_fhe_cpu.a",
            "public_key": "share/c_fhe/network.pub",
            "private_key": "share/c_fhe/network.pri",
            "pkgconfig": "lib/pkgconfig/c_fhe.pc"}
    assert files == {k: str(root.resolve() / v) for k, v in want.items()}
    assert Path(files["shared"]).read_bytes() == Path(
        native.build_cpu()).read_bytes()
    assert Path(files["static"]).read_bytes() == \
        build.NATIVE_CPU_STATIC.read_bytes()
    assert Path(files["header"]).read_bytes() == (
        Path(native.__file__).parent / "c_fhe.h").read_bytes()
    # the card's shim is not installed
    assert not (root / "lib" / "libc_fhe.so").exists()


def test_pc_file_parses(prefix):
    root, _files = prefix
    lib = root.resolve() / "lib"
    assert inst.pkg_config(root, "--modversion") == __version__
    assert inst.pkg_config(root, "--cflags") == f"-I{root.resolve()}/include"
    assert inst.pkg_config(root, "--libs").split() == [
        f"-L{lib}", "-lc_fhe_cpu", "-l:libzstd.so.1", "-ldl", "-lpthread"]
    assert inst.pkg_config(root, "--static", "--libs").split()[-2:] == [
        "-lstdc++", "-lm"]
    assert inst.pkg_config(root, "--variable=keydir") == \
        f"{root.resolve()}/share/c_fhe"


@pytest.mark.parametrize("static", [False, True], ids=["shared", "static"])
def test_pkg_config_host_passes(prefix, tmp_path, static):
    root, _files = prefix
    exe = inst.build_host(root, tmp_path / "host_test", static)
    proc = subprocess.run([str(exe), *inst.host_keys(root)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "HOST TEST PASSED" in proc.stdout, (
        proc.stdout + proc.stderr)
    deps = subprocess.run(["ldd", str(exe)], capture_output=True,
                          text=True).stdout
    assert ("libc_fhe_cpu" in deps) != static
    assert "python" not in deps.lower()


def test_command_line_installs(tmp_path):
    proc = subprocess.run([sys.executable, "-m",
                           "fhe_precompiles_tpu_torch.native.install",
                           "--prefix", str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["pkgconfig"] == str(
        tmp_path.resolve() / "lib" / "pkgconfig" / "c_fhe.pc")


CLEAN_CHECK = """
import json, sys
import fhe_precompiles_tpu_torch as port
from fhe_precompiles_tpu_torch import FheApp, native, pack
from fhe_precompiles_tpu_torch.native import codec
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
jax = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "fhe_precompiles_tpu"))
lib = native.build_cpu()
nf = native.NativeFhe(lib)
nf.use_zstd(codec.process_zstd())
data = pack.pack_two_arguments(21, pack.I64, b"ci", pack.BYTES)
code, ct = nf.call("encrypt_i64", data)
dcode, out = nf.call("decrypt_i64", pack.pack_one_argument(ct, pack.BYTES))
want = FheApp(TESTNET_ONE, engine="golden").call("encrypt_i64", data)
print(json.dumps({"package": port.__file__, "library": lib, "jax": jax,
                  "codes": [code, dcode],
                  "value": int.from_bytes(out, "big", signed=True),
                  "equal_to_golden": want == (code, ct)}))
"""


def test_clean_install(tmp_path):
    src = tmp_path / "src"
    skip = shutil.ignore_patterns("_build", "__pycache__", "*.pyc", "*.so",
                                  "*.o", "*.a", "fuzz_corpus", "host_test*")
    for pkg in ("fhe_precompiles_tpu", "fhe_precompiles_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=skip)
    for f in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy(REPO / f, src / f)
    venv = tmp_path / "venv"
    subprocess.run([sys.executable, "-m", "venv", "--system-site-packages",
                    str(venv)], check=True, timeout=300)
    py = venv / "bin" / "python"
    # this interpreter's packages (torch, numpy, setuptools) for the venv
    inner = subprocess.run([str(py), "-c",
                            "import site; print(site.getsitepackages()[0])"],
                           capture_output=True, text=True,
                           check=True).stdout.strip()
    Path(inner, "_outer.pth").write_text("\n".join(site.getsitepackages())
                                         + "\n")
    # the install and the check take 19 s together
    proc = bounded.run([str(py), "-m", "pip", "install", "--no-deps",
                        "--no-build-isolation", "--no-index", str(src)],
                       timeout=90, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    proc = bounded.run([str(py), "-c", CLEAN_CHECK], timeout=90,
                       cwd=elsewhere, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    installed = Path(inner) / "fhe_precompiles_tpu_torch"
    assert out["package"] == str(installed / "__init__.py")
    assert out["library"] == str(installed / "_build" / "libc_fhe_cpu.so")
    assert out["jax"] == []
    assert out["codes"] == [0, 0] and out["value"] == 21
    assert out["equal_to_golden"]

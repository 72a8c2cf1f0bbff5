"""The port's C ABI (``fhe_precompiles_tpu_torch/native``) against the JAX
package's: the same 51 exported symbols and error strings, and for all 49
precompiles the bytes and codes of the JAX package's ``libc_fhe.so`` on its
default golden engine, loaded in this process beside the port's.  The
port's library runs the app ``use_app`` names: its golden engine, and its
torch engine on the CPU (plain versions).  Also: four concurrent host
threads, and the standalone C host, which without a card must get code 7
from every call (the default app is the torch engine on the card; nothing
falls back).

Builds both shims with g++ (seconds); the JAX package's from its own
source into a temporary directory, so that no file of that package is
written."""
import ctypes
import shutil
import subprocess
import sysconfig
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

import fhe_precompiles_tpu
from fhe_precompiles_tpu.native import NativeFhe as JNativeFhe

import chip_smoke
from fhe_precompiles_tpu_torch import FheApp, PRECOMPILE_NAMES, native, pack
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext
from fhe_precompiles_tpu_torch.params import TESTNET_ONE

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no C/C++ toolchain")

SYMBOLS = {f"c_fhe_{name}" for name in PRECOMPILE_NAMES} | {"fhe_free",
                                                          "fhe_error"}
ERRORS = {1: "Unexpected end of file", 2: "Platform architecture invalid",
          3: "Invalid encoding", 4: "Overflow in FHE program",
          5: "Invalid decryption", 6: "Invalid encryption",
          7: "Base sunscreen error", 0: "Unknown error", 42: "Unknown error"}


@pytest.fixture(scope="module")
def port_lib():
    lib = native.NativeFhe()
    yield lib
    native.use_app(None)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's shim, built from its source with its Makefile's
    flags into a temporary directory."""
    src = Path(fhe_precompiles_tpu.__file__).parent / "native"
    out = tmp_path_factory.mktemp("jax_native") / "libc_fhe.so"
    libdir = sysconfig.get_config_var("LIBDIR")
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared",
           "-I", sysconfig.get_config_var("INCLUDEPY"),
           str(src / "c_fhe.cpp"), "-o", str(out), f"-L{libdir}",
           f"-Wl,-rpath,{libdir}",
           f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    subprocess.run(cmd, check=True, capture_output=True)
    return JNativeFhe(str(out))


@pytest.fixture(scope="module")
def calldata():
    golden = FheApp(TESTNET_ONE)
    user_pk, _ = BfvContext(TESTNET_ONE).generate_keys(seed=b"\x4a" * 64)
    return {name: chip_smoke.app_calldata(golden, user_pk, name)
            for name in PRECOMPILE_NAMES}


@pytest.fixture(scope="module")
def jax_results(jax_lib, calldata):
    return {name: jax_lib.call(name, calldata[name])
            for name in PRECOMPILE_NAMES}


@pytest.fixture(scope="module")
def apps():
    return {"golden": FheApp(TESTNET_ONE),
            "torch": FheApp(TESTNET_ONE, engine="torch", device="cpu")}


def _exported(path) -> set:
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)],
                         check=True, capture_output=True, text=True).stdout
    return {line.split()[-1] for line in out.splitlines()
            if line.split()[-2:-1] == ["T"]}


@pytest.mark.skipif(shutil.which("nm") is None, reason="no nm")
def test_exports_exactly_the_51_symbols_of_the_jax_shim(port_lib, jax_lib):
    assert _exported(native.LIB_PATH) == SYMBOLS
    assert _exported(jax_lib.lib._name) == SYMBOLS
    assert len(SYMBOLS) == 51


def test_every_symbol_resolves(port_lib):
    for name in SYMBOLS:
        assert hasattr(port_lib.lib, name), name


@pytest.mark.parametrize("code", sorted(ERRORS))
def test_error_strings_as_the_jax_shims(port_lib, jax_lib, code):
    assert port_lib.error_str(code) == ERRORS[code]
    assert jax_lib.error_str(code) == ERRORS[code]


def test_build_is_reused_until_the_sources_change(port_lib):
    """The same sources and command: no build.  A stamp that does not match
    them (as after an edit of c_fhe.cpp): a new build, and the stamp
    again."""
    lib = Path(native.build())
    stamp_file = lib.with_name(lib.name + ".sha256")
    stamp = stamp_file.read_text()
    inode = lib.stat().st_ino
    assert Path(native.build()).stat().st_ino == inode
    assert stamp_file.read_text() == stamp
    stamp_file.write_text("0" * 64)
    assert Path(native.build()).stat().st_ino != inode
    assert stamp_file.read_text() == stamp


@pytest.mark.parametrize("engine", ["golden", "torch"])
@pytest.mark.parametrize("name", PRECOMPILE_NAMES)
def test_precompile_equals_the_jax_library(port_lib, jax_results, calldata,
                                           apps, engine, name):
    native.use_app(apps[engine])
    got = port_lib.call(name, calldata[name])
    assert got[0] == 0, (name, got[0])
    assert got == jax_results[name], name


@pytest.mark.parametrize("name,data,code", [
    ("add_cipheru256_cipheru256", b"\x00", 1),
    ("encrypt_u256", b"\x00\x00", 1),
    ("decrypt_u64", b"garbage", 3),
])
def test_errors_as_the_jax_library(port_lib, jax_lib, apps, name, data,
                                   code):
    native.use_app(apps["torch"])
    assert port_lib.call(name, data) == (code, b"")
    assert jax_lib.call(name, data) == (code, b"")


def test_round_trip_through_the_abi(port_lib, apps):
    native.use_app(apps["torch"])
    data = pack.pack_two_arguments(12, pack.U256, b"\x01\x02\x03",
                                   pack.BYTES)
    code, ct = port_lib.call("encrypt_u256", data)
    assert code == 0 and len(ct) > 1000
    code, out = port_lib.call("decrypt_u256", ct)
    assert code == 0 and pack.U256.deserialize(out) == 12


def test_concurrent_host_threads(port_lib, apps, calldata):
    """Four threads call in at once; each call's result equals the one made
    alone."""
    native.use_app(apps["torch"])
    names = ["public_key_bytes", "add_cipheru64_cipheru64",
             "sub_cipheri64_i64", "decrypt_u64"] * 2
    want = [apps["torch"].call(name, calldata[name]) for name in names]
    with ThreadPoolExecutor(max_workers=4) as ex:
        futs = [ex.submit(port_lib.call, name, calldata[name])
                for name in names]
        got = [f.result(timeout=10) for f in futs]
    assert got == want


def test_default_app_is_the_card(port_lib):
    """With no app named the ABI runs testnet.one.FHE, the torch engine on
    the card: without one every call gives code 7."""
    native.use_app(None)
    if torch.cuda.is_available():
        assert native.current_app()._engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.current_app()
    assert port_lib.call("public_key_bytes", b"") == (7, b"")
    out = ctypes.c_void_p()
    out_len = ctypes.c_int64(5)
    fn = port_lib._fn("encrypt_u64")
    assert fn(b"\x00" * 20, 20, ctypes.byref(out), ctypes.byref(out_len)) == 7
    assert out.value is None and out_len.value == 0


def test_standalone_c_host_without_a_card_gets_code_7(tmp_path):
    """A C program (no Python parent) linking the port's library: on a
    machine without a card every one of the 49 precompiles returns 7, and
    the reason is the default app's refusal, not a failed start."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py runs the host")
    exe = native.build_host_test()
    res = subprocess.run([exe, "--no-card"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO-CARD TEST PASSED" in res.stdout
    assert "no CUDA device is available" in res.stderr

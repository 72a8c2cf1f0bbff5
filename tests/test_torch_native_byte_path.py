"""The port's byte path on the CPU without Python compute: ``FheApp(engine=
"native")`` over the C++ host engine, and the CPU library
``_build/libc_fhe_cpu.so`` (the reference's 51 symbols in C++, built by
``native.build_cpu``) with its static form and its C host.

The counterpart of ``tests/test_native_byte_path.py``.  For the 49
precompiles and the error-code cases, on calldata made from a seed, the
port's native app and the CPU library (by ctypes, on this process's zstd
build) give the same (code, bytes) as the JAX package's ``FheApp(engine=
"native")``, its golden ``FheApp`` and its pure-C++ library
``libc_fhe_native.so`` (the JAX package's libraries built by g++ from its
own sources into a temporary directory, so that no file of that package is
written).  Size-1 ciphertexts split the JAX package's stacks (golden gives
5 where its C++ engine decrypts); there the port's native app and CPU
library are held to the JAX package's C++ engine and library alone.
"""
import ctypes
import dataclasses
import hashlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import fhe_precompiles_tpu
from fhe_precompiles_tpu import FheApp as JFheApp
from fhe_precompiles_tpu.native import NativeFhe as JNativeFhe
from fhe_precompiles_tpu.native import engine as jengine
from fhe_precompiles_tpu.params import BENCH_N8192 as J_N8192
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE

import chip_smoke
from fhe_precompiles_tpu_torch import FheApp, PRECOMPILE_NAMES, native, pack
from fhe_precompiles_tpu_torch.app import _CT_CODEC
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.native.codec import (ZstdBuildRefused,
                                                    process_zstd)
from fhe_precompiles_tpu_torch.native.engine import NativeEngine
from fhe_precompiles_tpu_torch.ops import build
from fhe_precompiles_tpu_torch.params import BENCH_N8192, TESTNET_ONE
from fhe_precompiles_tpu_torch.serialization import keyio

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="no C/C++ toolchain")

SYMBOLS_51 = {f"c_fhe_{name}" for name in PRECOMPILE_NAMES} | {"fhe_free",
                                                             "fhe_error"}
KEY_AND_ZSTD = {"fhe_tpu_init_keys", "fhe_tpu_use_libzstd",
                "fhe_tpu_zstd_canonical"}
JAX_NATIVE = Path(fhe_precompiles_tpu.__file__).parent / "native"
JAX_FLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17"]


def _jax_library(out: Path) -> Path:
    """The JAX package's ``libc_fhe_native.so`` by its Makefile's flags,
    its two sources compiled side by side."""
    objs = [out.with_name(f"{src}.o") for src in ("precompiles",
                                                  "host_engine")]
    procs = [subprocess.Popen(["g++", *JAX_FLAGS, "-c",
                               str(JAX_NATIVE / f"{o.stem}.cpp"), "-o",
                               str(o)]) for o in objs]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    subprocess.run(["g++", "-shared", *map(str, objs), "-o", str(out),
                    "-lzstd", "-ldl"], check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's C++ library (bound to its embedded network keys by
    ``fhe_tpu_init_keys``, as its data/ lies elsewhere) and its host engine,
    bound by its ``NativeEngine`` for this module."""
    d = tmp_path_factory.mktemp("jax_native")
    lib = JNativeFhe(str(_jax_library(d / "libc_fhe_native.so")))
    engine = d / "libhost_engine.so"
    subprocess.run(["g++", "-shared", str(d / "host_engine.o"), "-o",
                    str(engine)], check=True, capture_output=True)
    data = Path(fhe_precompiles_tpu.__file__).parent / "data"
    pub, pri = ((data / f"network.{x}").read_bytes() for x in ("pub", "pri"))
    fn = lib.lib.fhe_tpu_init_keys
    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                   ctypes.c_size_t]
    assert fn(pub, len(pub), pri, len(pri)) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "build", lambda force=False: str(engine))
        yield lib


@pytest.fixture(scope="module")
def cpu_lib():
    """The port's CPU library on this process's zstd build."""
    lib = native.NativeFhe(native.build_cpu())
    lib.use_zstd(process_zstd())
    return lib


@pytest.fixture(scope="module")
def apps(jax_libs):
    return {"native": FheApp(TESTNET_ONE, engine="native"),
            "jax_native": JFheApp(J_ONE, engine="native"),
            "jax_golden": JFheApp(J_ONE)}


@pytest.fixture(scope="module")
def user_keys():
    return BfvContext(TESTNET_ONE).generate_keys(seed=b"\x5a" * 64)


@pytest.fixture(scope="module")
def calldata(user_keys):
    golden = FheApp(TESTNET_ONE)
    return {name: chip_smoke.app_calldata(golden, user_keys[0], name)
            for name in PRECOMPILE_NAMES}


def _all(apps, jax_libs, cpu_lib, name, data, golden=True) -> dict:
    """(code, bytes) of one call on every stack (the JAX golden app unless
    `golden` is False; the libraries only for a name they export)."""
    got = {"native": apps["native"].call(name, data),
           "jax_native": apps["jax_native"].call(name, data)}
    if name in PRECOMPILE_NAMES:
        got["cpu_lib"] = cpu_lib.call(name, data)
        got["jax_lib"] = jax_libs.call(name, data)
    if golden:
        got["jax_golden"] = apps["jax_golden"].call(name, data)
    return got


def _same(got: dict) -> tuple:
    first = next(iter(got.values()))
    assert all(v == first for v in got.values()), {
        k: (v[0], hashlib.sha256(v[1]).hexdigest()[:12])
        for k, v in got.items()}
    return first


# ---------------------------------------------------------------------------
# the 49 precompiles and the error codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRECOMPILE_NAMES)
def test_precompile_equal_on_every_stack(apps, jax_libs, cpu_lib, calldata,
                                         user_keys, name):
    code, out = _same(_all(apps, jax_libs, cpu_lib, name, calldata[name]))
    assert code == 0
    chip_smoke.app_check_value(FheApp(TESTNET_ONE), user_keys[1], name, out)


def _error_cases(user_keys, calldata):
    golden = FheApp(TESTNET_ONE)
    cases = chip_smoke.app_error_cases(golden, user_keys, calldata)
    ctx = golden.ctx
    pk = user_keys[0]
    wrong_key = ctx.encrypt(PLAIN_TYPES["u64"].encode(5, TESTNET_ONE), pk,
                            b"\x31" * 64)
    a = ctx.encrypt(PLAIN_TYPES["u64"].encode(3, TESTNET_ONE), pk,
                    b"\x32" * 64)
    relinless = dataclasses.replace(pk, relin=None)
    return cases + [
        ("key other than the network's", "decrypt_u64",
         pack.pack_one_argument(wrong_key, _CT_CODEC), 5),
        ("relin-less key into add", "add_cipheru64_cipheru64",
         pack.pack_binary_operation(relinless, a, _CT_CODEC, a, _CT_CODEC), 0),
        ("infinite plaintext", "encrypt_frac64",
         pack.pack_two_arguments(float("inf"), pack.FRAC64, b"x",
                                 pack.BYTES), 6),
        ("plaintext beyond the ring", "encrypt_frac64",
         pack.pack_two_arguments(1e308, pack.FRAC64, b"x", pack.BYTES), 6),
        ("offset past the end", "reencrypt_u64",
         (10_000_000).to_bytes(4, "big") + b"\x00" * 64, 1),
    ]


@pytest.fixture(scope="module")
def error_cases(user_keys, calldata):
    return _error_cases(user_keys, calldata)


@pytest.mark.parametrize("i", range(23))
def test_error_code_equal_on_every_stack(apps, jax_libs, cpu_lib,
                                         error_cases, i):
    """chip_smoke.py's 18 invalid or odd inputs and five of the reference's
    own cases: the same code (and bytes, where it succeeds) everywhere, but
    for the one case where the JAX package's app and library differ."""
    label, name, data, code = error_cases[i]
    got = _all(apps, jax_libs, cpu_lib, name, data)
    if label.startswith("size-0"):
        # the JAX package splits here: its apps multiply the empty
        # ciphertext (0), its C++ library refuses it (7); each port stack
        # is held to its counterpart
        libs = {k: got.pop(k) for k in ("cpu_lib", "jax_lib")}
        assert _same(libs) == (7, b"")
    assert _same(got)[0] == code, label


def test_error_case_count(error_cases):
    assert len(error_cases) == 23


def _size_one(rng) -> Ciphertext:
    data = np.stack([rng.integers(0, p, TESTNET_ONE.n, dtype=np.uint64)
                     for p in TESTNET_ONE.ct_moduli])[None]
    return Ciphertext(TESTNET_ONE, data)


@pytest.mark.parametrize("tname", ["u256", "u64", "i64", "frac64"])
def test_size_one_inputs_follow_the_jax_native_stack(apps, jax_libs, cpu_lib,
                                                     user_keys, tname):
    """Size-1 ciphertexts into decrypt, reencrypt and the binary ops: the
    port's native app and CPU library against the JAX package's C++ engine
    and library only (its golden app takes another path there)."""
    rng = np.random.default_rng(ord(tname[-1]))
    c1 = _size_one(rng)
    pk = user_keys[0]
    other = FheApp(TESTNET_ONE).ctx.encrypt(
        PLAIN_TYPES["u64"].encode(3, TESTNET_ONE), pk, b"\x33" * 64)
    scalar = chip_smoke.SCALARS[tname]
    value = chip_smoke.app_value(tname, 2)
    calls = [
        (f"decrypt_{tname}", pack.pack_one_argument(c1, _CT_CODEC)),
        (f"reencrypt_{tname}", pack.pack_binary_operation(
            pk, c1, _CT_CODEC, b"\x01", pack.BYTES)),
        (f"add_cipher{tname}_cipher{tname}", pack.pack_binary_operation(
            pk, c1, _CT_CODEC, other, _CT_CODEC)),
        (f"sub_cipher{tname}_cipher{tname}", pack.pack_binary_operation(
            pk, other, _CT_CODEC, c1, _CT_CODEC)),
        (f"mul_cipher{tname}_cipher{tname}", pack.pack_binary_operation(
            pk, c1, _CT_CODEC, other, _CT_CODEC)),
        (f"mul_cipher{tname}_{tname}", pack.pack_binary_operation(
            pk, c1, _CT_CODEC, value, scalar)),
        (f"sub_{tname}_cipher{tname}", pack.pack_binary_operation(
            pk, value, scalar, c1, _CT_CODEC)),
    ]
    for name, data in calls:
        _same(_all(apps, jax_libs, cpu_lib, name, data, golden=False))
    if tname == "frac64":
        # the split itself: the C++ stacks decrypt, golden does not
        data = calls[0][1]
        assert apps["native"].call(calls[0][0], data)[0] == 0
        assert apps["jax_golden"].call(calls[0][0], data)[0] == 5


@pytest.mark.parametrize("seed", range(2))
def test_random_bytes_give_the_same_code(apps, jax_libs, cpu_lib, seed):
    rng = np.random.default_rng(seed)
    for name in PRECOMPILE_NAMES:
        for size in (0, 1, 7, 64, 300):
            data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            _same(_all(apps, jax_libs, cpu_lib, name, data, golden=False))


# ---------------------------------------------------------------------------
# the CPU library
# ---------------------------------------------------------------------------

def _dynamic_symbols(path) -> set:
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)],
                         check=True, capture_output=True, text=True).stdout
    return {f[2] for f in map(str.split, out.splitlines())
            if len(f) == 3 and f[1] == "T"}


def test_cpu_library_exports_the_51_and_the_key_and_zstd_calls(cpu_lib):
    path = Path(cpu_lib.lib._name)
    assert path == build.NATIVE_CPU_LIB
    assert _dynamic_symbols(path) == SYMBOLS_51 | KEY_AND_ZSTD
    # the codec library's surface is unchanged: no c_fhe_* name
    codec = _dynamic_symbols(build.build_native_codec())
    assert "fhe_tpu_unpack_binary" in codec
    assert not codec & (SYMBOLS_51 - {"fhe_free"})
    # the static form holds the same two objects
    members = subprocess.run(["ar", "t", str(build.NATIVE_CPU_STATIC)],
                             check=True, capture_output=True,
                             text=True).stdout.split()
    assert members == ["precompiles.o", "host_engine.o"]


def test_cpu_library_zstd_build(cpu_lib):
    """On this process's build the frames are canonical where ``zstandard``
    imports; a build that does not load is refused and changes nothing."""
    before = cpu_lib.zstd_canonical()
    with pytest.raises(ZstdBuildRefused) as err:
        cpu_lib.use_zstd("/nonexistent/libzstd.so.1")
    assert err.value.code == 1
    assert cpu_lib.zstd_canonical() == before
    if process_zstd() != "system":
        assert before


def test_keys_named_through_init_keys(jax_libs, tmp_path):
    """A second load of the CPU library (a copy, so that it starts unbound)
    takes bench.n8192 keys through ``fhe_tpu_init_keys`` and infers the
    parameter set from them; its calls equal the JAX package's native app
    on the same keys.  The bound library refuses other keys."""
    ctx = BfvContext(BENCH_N8192)
    pk, sk = ctx.generate_keys(seed=b"\x42" * 64)
    pub, pri = keyio.save_public_key(pk), keyio.save_private_key(sk)
    copy = tmp_path / "libc_fhe_cpu.so"
    shutil.copy(native.build_cpu(), copy)
    lib = native.NativeFhe(str(copy))
    lib.use_zstd(process_zstd())
    lib.init_keys(pub, pri)
    with pytest.raises(RuntimeError, match="code 3"):
        lib.init_keys(*(FheApp(TESTNET_ONE).public_key_bytes(), pri))
    app = JFheApp(J_N8192, pub, pri, engine="native")
    enc = pack.pack_two_arguments(6, pack.U64, b"q", pack.BYTES)
    for name, data in (("public_key_bytes", b""), ("encrypt_u64", enc)):
        assert lib.call(name, data) == app.call(name, data), name
    c = Ciphertext.from_bytes(lib.call("encrypt_u64", enc)[1])
    mul = pack.pack_binary_operation(pk, c, _CT_CODEC, c, _CT_CODEC)
    got = lib.call("mul_cipheru64_cipheru64", mul)
    assert got[0] == 0 and got == app.call("mul_cipheru64_cipheru64", mul)
    dec = pack.pack_one_argument(Ciphertext.from_bytes(got[1]), _CT_CODEC)
    assert lib.call("decrypt_u64", dec) == app.call("decrypt_u64", dec) == (
        0, (36).to_bytes(8, "big"))


def _ldd(exe: str) -> str:
    return subprocess.run(["ldd", exe], capture_output=True,
                          text=True).stdout.lower()


def test_c_host_against_the_cpu_library(tmp_path):
    """host_test.c linked to ``libc_fhe_cpu.so``: no Python among its
    dependencies, and its default mode passes without a card."""
    exe = native.build_host_test("cpu")
    deps = _ldd(exe)
    assert "libc_fhe_cpu.so" in deps and "python" not in deps
    res = subprocess.run([exe], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "HOST TEST PASSED" in res.stdout


def test_static_c_host_names_its_keys(tmp_path):
    """host_test.c linked to ``libc_fhe_cpu.a``: neither the library nor
    Python among its dependencies.  Away from the package it finds no
    data/ by ``dladdr`` (every call 7); with ``--keys`` it hands the key
    files to ``fhe_tpu_init_keys`` and passes."""
    exe = tmp_path / "host_test_cpu_static"
    shutil.copy(native.build_host_test("cpu_static"), exe)
    deps = _ldd(str(exe))
    assert "libc_fhe" not in deps and "python" not in deps
    res = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert res.returncode == 1 and "public_key_bytes failed: code 7" in \
        res.stderr, res.stdout + res.stderr
    data = build.BUILD_DIR.parent / "data"
    res = subprocess.run([str(exe), "--keys", str(data / "network.pub"),
                          str(data / "network.pri")], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "HOST TEST PASSED" in res.stdout


def test_the_two_libraries_in_one_process_keep_their_own_names(cpu_lib,
                                                              calldata):
    """``libc_fhe.so`` (the card) and ``libc_fhe_cpu.so`` loaded side by
    side (ctypes: RTLD_LOCAL): the same name computes through the CPU
    library and gives 7 through the card's without a card; neither routes
    to the other."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py runs both")
    card = native.NativeFhe()
    native.use_app(None)
    for name in ("public_key_bytes", "encrypt_u64", "add_cipheru64_cipheru64"):
        assert cpu_lib.call(name, calldata[name])[0] == 0
        assert card.call(name, calldata[name]) == (7, b"")
        assert cpu_lib.call(name, calldata[name])[0] == 0
    fn = "c_fhe_public_key_bytes"
    assert ctypes.cast(getattr(card.lib, fn), ctypes.c_void_p).value != \
        ctypes.cast(getattr(cpu_lib.lib, fn), ctypes.c_void_p).value


def test_concurrent_calls(apps, cpu_lib, calldata):
    """Four threads through the CPU library and the native app at once:
    every result equals the one made alone."""
    names = ["mul_cipheru64_cipheru64", "add_cipheri64_i64", "reencrypt_u64",
             "decrypt_frac64"] * 2
    want = [apps["native"].call(name, calldata[name]) for name in names]
    with ThreadPoolExecutor(max_workers=4) as ex:
        for fn in (cpu_lib.call, apps["native"].call):
            futs = [ex.submit(fn, name, calldata[name]) for name in names]
            assert [f.result(timeout=60) for f in futs] == want


def test_native_app_touches_no_card():
    """The engine is named, not a fallback: it holds no tensor and no
    device, and ``engine="torch"`` still needs the card."""
    app = FheApp(TESTNET_ONE, engine="native")
    assert isinstance(app._engine, NativeEngine)
    assert not any(isinstance(v, torch.Tensor)
                   for v in vars(app._engine).values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FheApp(TESTNET_ONE, engine="torch")

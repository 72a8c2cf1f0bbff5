"""The port's C++ host engine (``fhe_precompiles_tpu_torch/native/engine.py``
over ``_build/libhost_engine.so``) against the JAX package's
``NativeEngine`` and golden model.

The counterpart of ``tests/test_native_engine.py``: every operation, keygen
and the samplers, on inputs made from a numpy seed, give the same words on
the port's engine, on the JAX package's engine (its library built by g++
from its own source into a temporary directory, so that no file of that
package is written) and on the JAX package's golden model, on
``testnet.one``, ``bench.n1024`` and ``bench.n8192``.  Size-1 ciphertexts,
where the golden model fails, are held to the JAX package's engine alone.
Exact integer arithmetic: every comparison is ``np.array_equal``.
"""
import ctypes
import dataclasses
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import fhe_precompiles_tpu
from fhe_precompiles_tpu import sampling as jsampling
from fhe_precompiles_tpu.bfv import golden as jgolden
from fhe_precompiles_tpu.native import engine as jengine
from fhe_precompiles_tpu.params import BENCH_N1024 as J_N1024
from fhe_precompiles_tpu.params import BENCH_N8192 as J_N8192
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import FheApp
from fhe_precompiles_tpu_torch.bfv.golden import (BfvContext, Ciphertext,
                                                  PublicKey, RelinKeys)
from fhe_precompiles_tpu_torch.native import engine as pengine
from fhe_precompiles_tpu_torch.native.engine import NativeEngine
from fhe_precompiles_tpu_torch.ops import build
from fhe_precompiles_tpu_torch.params import (BENCH_N1024, BENCH_N8192,
                                              TESTNET_ONE, Params,
                                              ntt_friendly_primes)
from fhe_precompiles_tpu_torch.sampling import (CBD_K, DOMAIN_ERROR,
                                                DOMAIN_TERNARY)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

PRESETS = {"testnet1": (TESTNET_ONE, J_ONE), "n1024": (BENCH_N1024, J_N1024),
           "n8192": (BENCH_N8192, J_N8192)}


@pytest.fixture(scope="module")
def jax_engine_lib(tmp_path_factory):
    """The JAX package's ``libhost_engine.so``, built from its source with
    its Makefile's command into a temporary directory, and bound by its
    ``NativeEngine`` for this module (its own build would write into the
    package)."""
    src = Path(fhe_precompiles_tpu.__file__).parent / "native"
    out = tmp_path_factory.mktemp("jax_engine") / "libhost_engine.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17",
                    "-shared", str(src / "host_engine.cpp"), "-o", str(out)],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "build", lambda force=False: str(out))
        yield out


class Trio:
    """One preset on three engines: the port's ``NativeEngine``, the JAX
    package's ``NativeEngine`` and the JAX package's golden model."""

    def __init__(self, name: str):
        self.p, self.jp = PRESETS[name]
        self.ctx = BfvContext(self.p)
        self.eng = NativeEngine(self.p, golden=self.ctx)
        self.jctx = jgolden.BfvContext(self.jp)
        self.jeng = jengine.NativeEngine(self.jp, golden=self.jctx)

    def jax(self, obj):
        """The JAX package's object holding the same words as `obj`."""
        if isinstance(obj, Ciphertext):
            return jgolden.Ciphertext(self.jp, obj.data)
        if isinstance(obj, RelinKeys):
            return jgolden.RelinKeys(self.jp, obj.data)
        if isinstance(obj, PublicKey):
            return jgolden.PublicKey(
                self.jp, obj.data,
                None if obj.relin is None else self.jax(obj.relin))
        return jgolden.SecretKey(self.jp, obj.s_ntt)

    def run(self, method: str, *args, golden: bool = True):
        """`method` on the three engines with the same inputs (port objects
        translated for the JAX package's); asserts the words are equal and
        returns the port's result."""
        jargs = [a if isinstance(a, (np.ndarray, bytes)) else self.jax(a)
                 for a in args]
        got = getattr(self.eng, method)(*args)
        outs = [getattr(self.jeng, method)(*jargs)]
        if golden:
            outs.append(getattr(self.jctx, method)(*jargs))
        for want in outs:
            assert np.array_equal(np.asarray(getattr(got, "data", got)),
                                  np.asarray(getattr(want, "data", want))), \
                method
        return got

    def plain(self, rng) -> np.ndarray:
        return rng.integers(0, self.ctx.t, self.ctx.n, dtype=np.uint64)


@pytest.fixture(scope="module")
def one(jax_engine_lib):
    trio = Trio("testnet1")
    pk, sk = trio.ctx.generate_keys(seed=b"\x42" * 64)
    rng = np.random.default_rng(42)
    m = [trio.plain(rng) for _ in range(3)]
    cts = [trio.ctx.encrypt(mi, pk, bytes([i]) * 64) for i, mi in enumerate(m)]
    return trio, pk, sk, m, cts


def test_add_sub_neg(one):
    trio, _pk, _sk, _m, (c0, c1, _) = one
    for method in ("add", "sub"):
        trio.run(method, c0, c1)
    trio.run("negate", c0)


def test_plain_ops(one):
    trio, _pk, _sk, m, (c0, _, _) = one
    for method in ("add_plain", "sub_plain", "mul_plain"):
        trio.run(method, c0, m[2])
    trio.run("plain_sub", m[2], c0)


def test_multiply_relinearize(one):
    trio, pk, _sk, _m, (c0, c1, _) = one
    c3 = trio.run("multiply", c0, c1)
    assert c3.size == 3
    trio.run("relinearize", c3, pk.relin)
    trio.run("mul_relin", c0, c1, pk.relin)


def test_encrypt_decrypt(one):
    trio, pk, sk, m, cts = one
    ce = trio.run("encrypt", m[0], pk, b"\x07" * 64)
    assert np.array_equal(trio.eng.decrypt(ce, sk), m[0])
    for ct in cts:
        trio.run("decrypt", ct, sk)
    prod = trio.run("mul_relin", cts[0], cts[1], pk.relin)
    trio.run("decrypt", prod, sk)


def test_decrypt_size3_and_wrong_key(one):
    """A size-3 product decrypts on all three; so does a ciphertext under
    another key, to the same garbage (decrypt's exact scale-and-round)."""
    trio, _pk, sk, _m, (c0, c1, _) = one
    trio.run("decrypt", trio.ctx.multiply(c0, c1), sk)
    _, sk2 = trio.ctx.generate_keys(seed=b"\x43" * 64)
    trio.run("decrypt", c0, sk2)


def test_size_one_ciphertexts_follow_the_jax_native_engine(one):
    """A size-1 ciphertext: the C++ engines decrypt it to c0's phase, where
    the golden model fails (the reference's three-way split on size 1), so
    the port's engine is held to the JAX package's engine alone.  Add and
    sub extend it by SEAL's zero extension on every engine."""
    trio, _pk, sk, m, (c0, _, _) = one
    rng = np.random.default_rng(7)
    data = np.stack([rng.integers(0, p, trio.ctx.n, dtype=np.uint64)
                     for p in TESTNET_ONE.ct_moduli])[None]
    c1 = Ciphertext(TESTNET_ONE, data)
    trio.run("decrypt", c1, sk, golden=False)
    with pytest.raises(TypeError):      # its dot with the key is None
        trio.jctx.decrypt(trio.jax(c1), trio.jax(sk))
    for method in ("add", "sub"):
        assert trio.run(method, c1, c0).size == 2
        trio.run(method, c0, c1)
    trio.run("mul_plain", c1, m[0])


@pytest.mark.parametrize("name", ["n1024", "n8192"])
def test_other_presets_bitexact(jax_engine_lib, name):
    trio = Trio(name)
    pk, sk = trio.ctx.generate_keys(seed=b"\x11" * 64)
    rng = np.random.default_rng(7)
    m1, m2 = trio.plain(rng), trio.plain(rng)
    c1 = trio.ctx.encrypt(m1, pk, b"\x01" * 64)
    c2 = trio.ctx.encrypt(m2, pk, b"\x02" * 64)
    trio.run("encrypt", m1, pk, b"\x03" * 64)
    trio.run("add", c1, c2)
    trio.run("decrypt", c1, sk)
    if pk.relin is not None:          # bench.n1024 has no special prime
        v = trio.run("mul_relin", c1, c2, pk.relin)
        trio.run("decrypt", v, sk)


@pytest.mark.parametrize("name", list(PRESETS))
def test_keygen_bitexact(jax_engine_lib, name):
    """``generate_keys(seed)``: the same secret, public and relin keys on
    the three engines; the keys work through the port's engine; relin=False
    strips the relin keys."""
    trio = Trio(name)
    seed = bytes(range(64))
    pk, sk = trio.eng.generate_keys(seed=seed)
    for jpk, jsk in (trio.jeng.generate_keys(seed=seed),
                     trio.jctx.generate_keys(seed=seed)):
        assert np.array_equal(sk.s_ntt, jsk.s_ntt)
        assert np.array_equal(pk.data, jpk.data)
        assert (pk.relin is None) == (jpk.relin is None)
        if pk.relin is not None:
            assert np.array_equal(pk.relin.data, jpk.relin.data)
    assert (pk.relin is None) == (trio.p.special_modulus is None)
    m = trio.plain(np.random.default_rng(3))
    c = trio.eng.encrypt(m, pk, b"\x05" * 64)
    assert np.array_equal(trio.eng.decrypt(c, sk), m)
    assert trio.eng.generate_keys(seed=seed, relin=False)[0].relin is None


def test_samplers_match_the_jax_package(one):
    """The C++ BLAKE2b XOF samplers (``he_sample_ternary``,
    ``he_sample_cbd_pair``) give the JAX package's ``sampling`` streams."""
    lib = pengine._load()
    i64p = ctypes.POINTER(ctypes.c_int64)
    for n in (1024, 4096, 8192):
        for seed in (b"\x00" * 64, bytes(range(64)), b"\xff" * 64):
            u, e0, e1 = (np.empty(n, dtype=np.int64) for _ in range(3))
            lib.he_sample_ternary(seed, DOMAIN_TERNARY, n,
                                  u.ctypes.data_as(i64p))
            lib.he_sample_cbd_pair(seed, DOMAIN_ERROR, n, CBD_K,
                                   e0.ctypes.data_as(i64p),
                                   e1.ctypes.data_as(i64p))
            assert np.array_equal(u, jsampling.sample_ternary(
                jsampling.Blake2Xof(seed, jsampling.DOMAIN_TERNARY), n))
            xof = jsampling.Blake2Xof(seed, jsampling.DOMAIN_ERROR)
            assert np.array_equal(e0, jsampling.sample_cbd(xof, n))
            assert np.array_equal(e1, jsampling.sample_cbd(xof, n))


def test_randomized_mul_chain(one):
    """Depth 2: the engine's outputs fed back in stay equal."""
    trio, pk, sk, _m, (c0, c1, c2) = one
    v = trio.run("mul_relin", c0, c1, pk.relin)
    v = trio.run("mul_relin", v, c2, pk.relin)
    trio.run("decrypt", v, sk)


def test_concurrent_ops_bit_exact(one):
    """Four threads run mul_relin, encrypt and decrypt at once; every
    output equals the JAX package's golden model's (the engine's const
    context and per-thread scratch)."""
    trio, pk, sk, m, (c0, c1, _) = one
    j = trio.jax
    want_mul = trio.jctx.mul_relin(j(c0), j(c1), j(pk.relin)).data
    want_enc = trio.jctx.encrypt(m[0], j(pk), b"\x09" * 64).data
    want_dec = trio.jctx.decrypt(j(c0), j(sk))

    def worker(_):
        for _ in range(5):
            assert np.array_equal(trio.eng.mul_relin(c0, c1, pk.relin).data,
                                  want_mul)
            assert np.array_equal(trio.eng.encrypt(m[0], pk,
                                                   b"\x09" * 64).data,
                                  want_enc)
            assert np.array_equal(trio.eng.decrypt(c0, sk), want_dec)
        return True

    with ThreadPoolExecutor(max_workers=4) as ex:
        assert all(ex.map(worker, range(4), timeout=120))


def test_range_and_shape_checks(one):
    """The JAX package's refusals: a parameter set beyond the engine's
    range, and operands of the wrong size or shape."""
    trio, pk, _sk, m, (c0, c1, _) = one
    wide = Params(poly_modulus_degree=1024,
                  coeff_modulus=ntt_friendly_primes(1024, 6, below=1 << 30),
                  plain_modulus=1024)
    with pytest.raises(ValueError, match=r"k <= 4 limbs, moduli < 2\*\*37, "
                                         r"q < 2\*\*122"):
        NativeEngine(wide)
    c3 = trio.ctx.multiply(c0, c1)
    with pytest.raises(ValueError, match="size-2"):
        trio.eng.multiply(c3, c1)
    with pytest.raises(ValueError, match="size-3"):
        trio.eng.relinearize(c0, pk.relin)
    bad_rk = RelinKeys(TESTNET_ONE, pk.relin.data[:, :, :2])
    with pytest.raises(ValueError, match="relin keys shaped"):
        trio.eng.relinearize(c3, bad_rk)
    bad_pk = dataclasses.replace(pk, data=pk.data[:, :1])
    with pytest.raises(ValueError, match="public key shaped"):
        trio.eng.encrypt(m[0], bad_pk, b"\x01" * 64)


def test_app_engine_native_is_named_and_makes_the_keys(jax_engine_lib):
    """``FheApp(engine="native")`` runs the C++ engine on the CPU and
    delegates keygen to it; an unknown name lists the three engines."""
    app = FheApp(TESTNET_ONE, engine="native")
    assert isinstance(app._engine, NativeEngine)
    assert app._engine.golden is app.ctx
    pk, sk = app.generate_keys()
    assert pk.relin is not None
    m = np.arange(TESTNET_ONE.n, dtype=np.uint64) % TESTNET_ONE.plain_modulus
    assert np.array_equal(app.ctx.decrypt(app._engine.encrypt(
        m, pk, b"\x02" * 64), sk), m)
    with pytest.raises(ValueError, match="'golden', 'torch' or 'native'"):
        FheApp(TESTNET_ONE, engine="jax")


def test_engine_library_is_the_ports_build(one):
    """Bound from ``_build/libhost_engine.so``, linked from the port's own
    ``host_engine.cpp``, its ``he_*`` calls exported."""
    lib = pengine._load()
    assert Path(lib._name) == build.HOST_ENGINE_LIB
    out = subprocess.run(["nm", "-D", "--defined-only", lib._name],
                         check=True, capture_output=True, text=True).stdout
    names = {f[2] for f in map(str.split, out.splitlines()) if len(f) == 3}
    assert {"he_ctx_new", "he_keygen", "he_relinearize",
            "he_sample_cbd_pair"} <= names
    assert not any(x.startswith("c_fhe_") for x in names)

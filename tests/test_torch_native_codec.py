"""The port's C++ codec library (``_build/libc_fhe_native.so``, built from
``fhe_precompiles_tpu_torch/native/``) and its ctypes view
``native.codec.NativeCodec``.

The library builds from the port's copy of the sources, reads no
environment variable and exports the ``fhe_tpu_*`` codec extension and
``fhe_free`` alone: the 51 symbols of the reference's C ABI and the ``he_*``
engine are compiled in but stay local, so that the card's ``libc_fhe.so``
remains the only C entry point and neither library binds the other's names.  Each codec half equals the port's python codecs
(``pack``, ``keyio``, ``encoding``, ``_CT_CODEC``) on calldata made from a
numpy seed: arrays, codes and bytes with tolerance 0.  Then the key
references and the zstd dispatch (the counterpart of the JAX package's
``tests/test_zstd_dispatch.py``): a refused build raises with its code and
leaves the codec as it was, and the bytes stay pinned across a swap.
"""
import ctypes
import ctypes.util
import hashlib
import importlib.util
import re
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import FheApp, native, pack
from fhe_precompiles_tpu_torch.app import (_CT_CODEC, _PK_CODEC,
                                           ENCRYPT_PRIVATE_CONSTANT)
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.native import codec as codec_mod
from fhe_precompiles_tpu_torch.ops import build
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
from fhe_precompiles_tpu_torch.serialization import keyio

P = TESTNET_ONE
K, N = len(P.ct_moduli), P.n
SCALARS = {"u256": pack.U256, "u64": pack.U64, "i64": pack.I64,
           "frac64": pack.FRAC64}
TYPES = tuple(SCALARS)
NAMES_51 = ({f"c_fhe_{name}" for name in __import__(
    "fhe_precompiles_tpu_torch").PRECOMPILE_NAMES} | {"fhe_free",
                                                       "fhe_error"})
TPU_NAMES = {"fhe_tpu_init_keys", "fhe_tpu_params", "fhe_tpu_use_libzstd",
             "fhe_tpu_zstd_canonical", "fhe_tpu_unpack_binary",
             "fhe_tpu_pk_id", "fhe_tpu_pk_digest", "fhe_tpu_pk_relin",
             "fhe_tpu_pk_release",
             "fhe_tpu_pack_ciphertext", "fhe_tpu_unpack_encrypt",
             "fhe_tpu_unpack_decrypt", "fhe_tpu_decode_scalar",
             "fhe_tpu_unpack_reencrypt", "fhe_tpu_reencrypt_finish",
             "fhe_tpu_pk_data"}


@pytest.fixture(scope="module")
def app():
    return FheApp(P, engine="torch", device="cpu")


@pytest.fixture(scope="module")
def cod(app):
    c = codec_mod.NativeCodec(app)
    yield c
    # leave the shared library on the build this process's python codec
    # uses, whatever a test swapped in
    c.use_zstd(codec_mod.process_zstd())


@pytest.fixture(scope="module")
def ctx():
    return BfvContext(P)


@pytest.fixture(scope="module")
def keys(ctx):
    return (ctx.generate_keys(seed=b"\x81" * 64),
            ctx.generate_keys(seed=b"\x82" * 64))


def _value(tname, v):
    return float(v) if tname == "frac64" else int(v)


def _ct(ctx, value, tname, pk, tag: bytes) -> Ciphertext:
    poly = PLAIN_TYPES[tname].encode(_value(tname, value), P)
    return ctx.encrypt(poly, pk, hashlib.sha512(tag).digest())


def _rand_ct(rng, size=2) -> Ciphertext:
    d = np.zeros((size, K, N), dtype=np.uint64)
    for j, p in enumerate(P.ct_moduli):
        d[:, j] = rng.integers(0, p, size=(size, N), dtype=np.uint64)
    return Ciphertext(P, d)


def _symbols(path, dynamic: bool) -> dict:
    """Defined function symbols -> nm's type letter ("T" global, "t"
    local): the dynamic table (what a loader can resolve) or the full one."""
    cmd = ["nm", "--defined-only"] + (["-D"] if dynamic else []) + [str(path)]
    out = subprocess.run(cmd, check=True, capture_output=True,
                         text=True).stdout
    return {f[2]: f[1] for f in map(str.split, out.splitlines())
            if len(f) == 3 and f[1] in "Tt"}


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

def test_library_builds_from_the_ports_sources_and_exports_both_surfaces(
        cod):
    """Of its two surfaces, the ``fhe_tpu_*`` codec (with ``fhe_free``) is
    the only one a loader can resolve; the reference's 51 symbols are
    compiled in as local symbols."""
    path = Path(cod.lib._name)
    assert path == build.NATIVE_CODEC_LIB
    assert path.parent.parent.name == "fhe_precompiles_tpu_torch"
    # linked from the two objects, each compiled from the port's source
    cmd = build.native_codec_command(path)
    objects = [Path(a) for a in cmd if a.endswith(".o")]
    assert {o.name for o in objects} == {"precompiles.o", "host_engine.o"}
    assert all(o.parent == build.BUILD_DIR for o in objects)
    sources = [Path(a) for o in objects
               for a in build.object_command(o.name, o) if a.endswith(".cpp")]
    assert {s.name for s in sources} == {"precompiles.cpp",
                                         "host_engine.cpp"}
    assert all(s.parent == build.NATIVE for s in sources)
    assert set(_symbols(path, dynamic=True)) == TPU_NAMES | {"fhe_free"}
    # the reference's 51 symbols and the he_* engine are compiled in, local
    every = _symbols(path, dynamic=False)
    assert {x: every.get(x) for x in NAMES_51} == {
        x: "T" if x == "fhe_free" else "t" for x in NAMES_51}
    assert every.get("he_multiply") == "t"
    assert len(NAMES_51) == 51 and len(TPU_NAMES) == 16


def test_build_is_reused_until_the_sources_change(cod):
    lib = build.build_native_codec()
    inode = lib.stat().st_ino
    assert build.build_native_codec().stat().st_ino == inode
    stamp = lib.with_name(lib.name + ".sha256")
    stamp.write_text("stale")
    assert build.build_native_codec().stat().st_ino != inode
    assert stamp.read_text() != "stale"


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "NATIVE_CODEC_LIB", tmp_path / "lib.so")
    monkeypatch.setattr(build, "native_codec_command",
                        lambda out: ["g++", "-x", "c++", "/nonexistent.cpp",
                                     "-o", str(out)])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build_native_codec()


def test_new_sources_read_no_environment():
    """The copies of the JAX package's sources lost its four environment
    reads; the import test's scan (every .py, .cpp, .c and .h of the
    package) covers them."""
    files = [build.NATIVE / name for name in build.NATIVE_CODEC_SOURCES]
    files.append(Path(codec_mod.__file__))
    pat = re.compile(r"\b(environ|getenv|secure_getenv|putenv)\b")
    for f in files:
        assert f.is_file()
        assert not pat.search(f.read_text()), f
    text = (build.NATIVE / "precompiles.cpp").read_text()
    assert "FHE_TPU_" not in text and "fhe_tpu_use_libzstd(path)" in text


def test_c_abi_computes_in_cpp_beside_the_python_shim(cod, app, ctx):
    """With the codec library and the port's shim in one process, a loader
    finds no ``c_fhe_*`` name in the codec library, the shim's 51 symbols
    still reach the Python app, and the codec's C++ decode of the same
    calldata equals the python codec's."""
    calls = []

    class Spy:
        def call(self, name, data):
            calls.append(name)
            return app.call(name, data)
    shim = native.NativeFhe()
    assert not hasattr(ctypes.CDLL(cod.lib._name), "c_fhe_decrypt_u64")
    with pytest.raises(AttributeError):
        native.NativeFhe(cod.lib._name)
    ct = _ct(ctx, 41, "u64", app.public_key, b"abi")
    data = pack.pack_one_argument(ct, _CT_CODEC)
    native.use_app(Spy())
    try:
        assert shim.call("decrypt_u64", data) == (0, (41).to_bytes(8, "big"))
        assert calls == ["decrypt_u64"]
    finally:
        native.use_app(None)
    code, got, size = cod.unpack_decrypt(data)
    assert (code, size) == (0, 2) and np.array_equal(got, ct.data)


def test_params_and_keys_agree_with_the_app(cod, app):
    assert (cod.n, cod.k, cod.kk) == (N, K, len(P.key_moduli))
    # a second codec on the same keys binds; other keys are refused
    assert codec_mod.NativeCodec(app).n == N
    pk, sk = BfvContext(P).generate_keys(seed=b"\x90" * 64)
    other = FheApp(P, network_public_key_bytes=keyio.save_public_key(pk),
                   network_private_key_bytes=keyio.save_private_key(sk))
    with pytest.raises(RuntimeError, match="different network keys"):
        codec_mod.NativeCodec(other)


# ---------------------------------------------------------------------------
# each codec half against the python codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tname", TYPES)
def test_unpack_binary_equals_the_python_codecs(cod, ctx, keys, tname):
    rng = np.random.default_rng(1000 + TYPES.index(tname))
    pk = keys[0][0]
    a = _ct(ctx, rng.integers(1, 1000), tname, pk, b"ua" + tname.encode())
    b = _ct(ctx, rng.integers(1, 1000), tname, pk, b"ub" + tname.encode())
    v = _value(tname, rng.integers(1, 1000))
    c = f"cipher{tname}"
    for op in ("add", "sub", "mul"):
        data = pack.pack_binary_operation(pk, a, _CT_CODEC, b, _CT_CODEC)
        code, shape, got_op, ct, other, sa, sb, ref = cod.unpack_binary(
            f"{op}_{c}_{c}", data)
        assert (code, shape, got_op, sa, sb) == (0, "cc", op, 2, 2)
        _pk, pa, pb = pack.unpack_binary_operation(data, _PK_CODEC,
                                                   _CT_CODEC, _CT_CODEC)
        assert np.array_equal(ct, pa.data) and np.array_equal(other, pb.data)
        ref.release()
        for shape_s, name, args in (
                ("cp", f"{op}_{c}_{tname}", (a, _CT_CODEC, v,
                                              SCALARS[tname])),
                ("pc", f"{op}_{tname}_{c}", (v, SCALARS[tname], a,
                                              _CT_CODEC))):
            data = pack.pack_binary_operation(pk, *args)
            code, shape, got_op, ct, other, sa, _sb, ref = \
                cod.unpack_binary(name, data)
            assert (code, shape, got_op, sa) == (0, shape_s, op, 2)
            assert np.array_equal(ct, a.data)
            assert np.array_equal(other,
                                  PLAIN_TYPES[tname].encode(v, P))
            ref.release()


def test_unpack_errors_are_fheapp_calls_codes(cod, app, ctx, keys):
    pk = keys[0][0]
    a = _ct(ctx, 3, "u64", pk, b"e")
    good = pack.pack_binary_operation(pk, a, _CT_CODEC, a, _CT_CODEC)
    rng = np.random.default_rng(7)
    cases = [good[:40], good[:-9], b"", b"\x00\x00\x00\x09" * 3,
             bytes(rng.integers(0, 256, 300, dtype=np.uint8))]
    flipped = bytearray(good)
    flipped[20] ^= 0xFF
    cases.append(bytes(flipped))
    for data in cases:
        for name in ("mul_cipheru64_cipheru64", "add_cipheru64_u64"):
            code = cod.unpack_binary(name, data)[0]
            assert code == app.call(name, data)[0] != 0
        assert cod.unpack_decrypt(data)[0] == app.call("decrypt_u64",
                                                       data)[0]


@pytest.mark.parametrize("tname", TYPES)
def test_unpack_encrypt_equals_the_python_codecs(cod, tname):
    rng = np.random.default_rng(2000 + TYPES.index(tname))
    for _ in range(3):
        v = _value(tname, rng.integers(0, 2 ** 31))
        public = rng.bytes(int(rng.integers(0, 40)))
        data = pack.pack_two_arguments(v, SCALARS[tname], public, pack.BYTES)
        code, m, seed = cod.unpack_encrypt(tname, data)
        assert code == 0
        assert np.array_equal(m, PLAIN_TYPES[tname].encode(v, P))
        assert seed == hashlib.sha512(public + ENCRYPT_PRIVATE_CONSTANT
                                      + SCALARS[tname].serialize(v)).digest()


def test_unpack_decrypt_and_reencrypt_equal_the_python_codecs(cod, ctx, keys):
    rng = np.random.default_rng(3000)
    for size in (2, 3):
        ct = _rand_ct(rng, size)
        data = pack.pack_one_argument(ct, _CT_CODEC)
        code, arr, got_size = cod.unpack_decrypt(data)
        assert (code, got_size) == (0, size)
        if size == 2:
            assert np.array_equal(arr, ct.data)
        blob = pack.pack_binary_operation(keys[1][0], ct, _CT_CODEC,
                                          b"pd", pack.BYTES)
        code, arr, got_size, ref = cod.unpack_reencrypt(blob)
        assert (code, got_size) == (0, size)
        if size == 2:
            assert np.array_equal(arr, ct.data)
        assert np.array_equal(ref.data(cod.kk, cod.n), keys[1][0].data)
        assert np.array_equal(ref.relin(cod.k, cod.kk, cod.n),
                              keys[1][0].relin.data)
        ref.release()


@pytest.mark.parametrize("tname", TYPES)
def test_decode_scalar_equals_the_python_codecs(cod, tname):
    """Polynomials that encode a value and polynomials of random
    coefficients mod t (mostly out of range: code 5)."""
    rng = np.random.default_rng(4000 + TYPES.index(tname))
    polys = [PLAIN_TYPES[tname].encode(_value(tname, v), P)
             for v in rng.integers(0, 2 ** 40, 4)]
    polys += [rng.integers(0, P.t, N, dtype=np.uint64) for _ in range(4)]
    polys.append(np.zeros(N, dtype=np.uint64))
    for poly in polys:
        try:
            want = (0, SCALARS[tname].serialize(
                PLAIN_TYPES[tname].decode(poly, P)))
        except Exception:
            want = (5, b"")
        assert cod.decode_scalar(tname, poly) == want


def test_pack_ciphertext_equals_the_python_codec(cod, ctx, keys):
    rng = np.random.default_rng(5000)
    cts = [_rand_ct(rng, 2), _rand_ct(rng, 3),
           _ct(ctx, 9, "u64", keys[0][0], b"pk")]
    for ct in cts:
        assert cod.pack_ciphertext(ct.data) == _CT_CODEC.serialize(ct)
        assert cod.pack_ciphertext(ct.data) == ct.to_bytes()


# ---------------------------------------------------------------------------
# key references
# ---------------------------------------------------------------------------

def test_pk_ids_equal_exactly_when_the_key_bytes_do(cod, ctx, keys):
    a = _ct(ctx, 1, "u64", keys[0][0], b"id")
    refs = []
    for pk in (keys[0][0], keys[1][0], keys[0][0],
               keyio.load_public_key(keys[1][0].to_bytes())):
        data = pack.pack_binary_operation(pk, a, _CT_CODEC, a, _CT_CODEC)
        refs.append(cod.unpack_binary("add_cipheru64_cipheru64", data)[-1])
    ids = [r.id for r in refs]
    assert ids[0] == ids[2] and ids[1] == ids[3] and ids[0] != ids[1]
    for r in refs:
        r.release()
        r.release()               # idempotent
        assert r._handle == 0


def test_one_key_parsed_by_threads_at_once_has_one_entry(cod, ctx, keys):
    """Threads that parse one key's new bytes at once get one cache entry
    (one id); the digest is the BLAKE2b-256 of the key's bytes."""
    pk = keys[0][0]
    a = _ct(ctx, 1, "u64", pk, b"race")
    for bump in (1, 2, 3):      # bytes the cache has not seen yet
        data = pk.data.copy()
        data[0, 0, 0] = (int(data[0, 0, 0]) + bump) % P.key_moduli[0]
        fresh = type(pk)(pk.params, data, pk.relin)
        blob = pack.pack_binary_operation(fresh, a, _CT_CODEC, a, _CT_CODEC)
        start = threading.Barrier(8)

        def unpack():
            start.wait()
            return cod.unpack_binary("add_cipheru64_cipheru64", blob)[-1]
        with ThreadPoolExecutor(8) as pool:
            refs = [f.result() for f in [pool.submit(unpack)
                                         for _ in range(8)]]
        want = hashlib.blake2b(fresh.to_bytes(), digest_size=32).digest()
        assert {r.id for r in refs} == {refs[0].id}, bump
        assert {r.digest for r in refs} == {want}, bump
        for r in refs:
            r.release()


# ---------------------------------------------------------------------------
# zstd dispatch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pinned(cod, ctx, keys):
    """A multiply's output array and the python codec's bytes for it."""
    pk = keys[0][0]
    a = _ct(ctx, 5, "u64", pk, b"za")
    b = _ct(ctx, 7, "u64", pk, b"zb")
    out = ctx.relinearize(ctx.multiply(a, b), pk.relin)
    blob = pack.pack_binary_operation(pk, a, _CT_CODEC, b, _CT_CODEC)
    return out.data, out.to_bytes(), blob, a.data


def test_default_zstd_is_the_python_codecs_build(cod, pinned):
    arr, want, _blob, _a = pinned
    assert cod.zstd_source == codec_mod.process_zstd()
    assert cod.pack_ciphertext(arr) == want
    if cod.zstd_source != "system":
        # a build the library accepted reproduces the canonical frames
        assert cod.zstd_canonical()


def test_bad_builds_are_refused_with_their_code(cod, pinned):
    arr, want, _blob, _a = pinned
    before = cod.zstd_source
    with pytest.raises(codec_mod.ZstdBuildRefused) as err:
        cod.use_zstd("/nonexistent/libzstd.so")
    assert err.value.code == 1 and "dlopen" in str(err.value)
    libm = ctypes.util.find_library("m")
    assert libm
    with pytest.raises(codec_mod.ZstdBuildRefused) as err:
        cod.use_zstd(libm)
    assert err.value.code == 2
    # the codec is unharmed: same build, same bytes
    assert cod.zstd_source == before
    assert cod.pack_ciphertext(arr) == want


def test_bytes_stay_pinned_across_a_swap(cod, pinned):
    """system -> wheel build -> system: the same bytes at every step, in
    both halves (compress through pack, decompress through unpack)."""
    arr, want, blob, a = pinned

    def both():
        out = cod.unpack_binary("mul_cipheru64_cipheru64", blob)
        out[-1].release()
        assert out[0] == 0 and np.array_equal(out[3], a)
        assert cod.pack_ciphertext(arr) == want

    cod.use_zstd("system")
    assert cod.zstd_source == "system"
    both()
    spec = importlib.util.find_spec("zstandard._cffi")
    if spec is not None and spec.origin:
        cod.use_zstd(spec.origin)
        assert cod.zstd_canonical()
        both()
    cod.use_zstd("system")
    both()

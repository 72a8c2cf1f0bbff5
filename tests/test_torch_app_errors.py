"""Error codes and odd inputs: the port's ``FheApp`` against the JAX
package's golden ``FheApp``.

Counterparts of ``test_error_code_matrix``, ``test_size_semantics`` and the
decrypt cases of ``test_decrypt_consensus``, then the replay of the checked-in
fuzz corpus (``fhe_precompiles_tpu/native/fuzz_seeds``, read as data).  Every
input goes through the JAX package's golden app and the port's two engines
(``"golden"``, ``"torch"`` on the CPU); the three must give the same code,
and the same bytes where the code is 0.  The JAX package's own tests hold its
``jax`` and ``native`` engines equal to its golden app.
"""
import copy
import dataclasses
import hashlib
import os
import struct

import numpy as np
import pytest

from fhe_precompiles_tpu import FheApp as JFheApp
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import FheApp, PRECOMPILE_NAMES, pack
from fhe_precompiles_tpu_torch.app import _CT_CODEC
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES, encode_frac64
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
from fhe_precompiles_tpu_torch.serialization import keyio
from fhe_precompiles_tpu_torch.serialization.bincode import Reader, Writer
from fhe_precompiles_tpu_torch.serialization.seal import (SealCiphertextBlob,
                                                          compute_parms_id)

P = TESTNET_ONE
K, N = len(P.ct_moduli), P.n
SCALARS = {"u256": pack.U256, "u64": pack.U64, "i64": pack.I64,
           "frac64": pack.FRAC64}
TYPES = list(SCALARS)
SEED_DIR = os.path.join(os.path.dirname(os.path.abspath(
    __import__("fhe_precompiles_tpu").__file__)), "native", "fuzz_seeds")
# the boundary-placed reproducer dot of test_decrypt_consensus
VERDICT_DOT = 6341038794891017812


@pytest.fixture(scope="module")
def apps():
    return {"jax_golden": JFheApp(J_ONE),
            "golden": FheApp(P),
            "torch": FheApp(P, engine="torch", device="cpu")}


@pytest.fixture(scope="module")
def user_keys():
    return BfvContext(P).generate_keys(seed=b"\x52" * 64)


def agree(apps, name, data):
    """(code, bytes) of the JAX golden app, after asserting the port's two
    engines give the same."""
    outs = {e: app.call(name, data) for e, app in apps.items()}
    want = outs["jax_golden"]
    for e, got in outs.items():
        assert got == want, (
            f"{name}: {e} gave code {got[0]} ({len(got[1])} bytes), the JAX "
            f"golden app code {want[0]} ({len(want[1])} bytes)")
    return want


def enc(apps, value, tname, pk, tag):
    g = apps["golden"]
    return g.ctx.encrypt(PLAIN_TYPES[tname].encode(value, P), pk,
                         hashlib.sha512(tag + tname.encode()).digest())


def rand_ct(size, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((size, K, N), dtype=np.uint64)
    for j, p in enumerate(P.ct_moduli):
        d[:, j] = rng.integers(0, p, size=(size, N), dtype=np.uint64)
    return Ciphertext(P, d)


# ---------------------------------------------------------------------------
# the error-code matrix (test_error_code_matrix)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf"),
                                 1e308])
def test_encrypt_frac64_nonfinite_is_failed_encryption(apps, bad):
    data = pack.pack_two_arguments(bad, pack.FRAC64, b"x", pack.BYTES)
    assert agree(apps, "encrypt_frac64", data) == (6, b"")


@pytest.mark.parametrize("tname", TYPES)
def test_framing_and_width_codes(apps, tname):
    v = 7.5 if tname == "frac64" else 7
    valid = pack.pack_two_arguments(v, SCALARS[tname], b"x", pack.BYTES)
    assert agree(apps, f"encrypt_{tname}", valid)[0] == 0
    assert agree(apps, f"encrypt_{tname}", b"\x00\x00")[0] == 1
    assert agree(apps, f"add_cipher{tname}_cipher{tname}",
                 b"\x00\x00\x00")[0] == 1
    wrong_width = pack.pack_two_arguments(b"\x01\x02\x03", pack.BYTES, b"x",
                                          pack.BYTES)
    assert agree(apps, f"encrypt_{tname}", wrong_width)[0] == 3


@pytest.mark.parametrize("name", ["encrypt_u64", "add_cipheru64_cipheru64",
                                  "reencrypt_u64"])
def test_oversized_offsets_unexpected_eof(apps, name):
    data = struct.pack(">I", 10_000_000) + b"\x00" * 64
    assert agree(apps, name, data)[0] == 1


def test_garbage_ciphertext_and_unknown_name(apps):
    data = pack.pack_one_argument(b"\xde\xad\xbe\xef" * 10, pack.BYTES)
    assert agree(apps, "decrypt_u64", data)[0] == 3
    assert agree(apps, "no_such_precompile", data) == (3, b"")
    assert agree(apps, "__init__", b"") == (3, b"")


@pytest.mark.parametrize("tname", ["u64", "i64"])
def test_decode_overflow_is_failed_decryption(apps, tname):
    ct = enc(apps, (1 << 200) + 5, "u256", apps["golden"].public_key, b"ovf")
    data = pack.pack_one_argument(ct, _CT_CODEC)
    assert agree(apps, f"decrypt_{tname}", data) == (5, b"")


def test_wrong_key_decrypt_and_reencrypt(apps, user_keys):
    pk, _ = user_keys
    ct = enc(apps, 5, "u64", pk, b"wrongkey")
    assert agree(apps, "decrypt_u64", pack.pack_one_argument(
        ct, _CT_CODEC))[0] == 5
    data = pack.pack_binary_operation(pk, ct, _CT_CODEC, b"pd", pack.BYTES)
    assert agree(apps, "reencrypt_u64", data)[0] == 5


def test_mul_without_relin_keys_and_size3_operands(apps, user_keys):
    pk, _ = user_keys
    bare = copy.copy(pk)
    bare.relin = None
    a, b = enc(apps, 3, "u64", pk, b"a"), enc(apps, 2, "u64", pk, b"b")
    data = pack.pack_binary_operation(bare, a, _CT_CODEC, b, _CT_CODEC)
    assert agree(apps, "mul_cipheru64_cipheru64", data)[0] == 7
    assert agree(apps, "add_cipheru64_cipheru64", data)[0] == 0
    # a never relinearized product: add accepts it, mul refuses it (7)
    c3 = apps["golden"].ctx.multiply(a, b)
    for first, second in ((c3, a), (a, c3), (c3, c3)):
        data = pack.pack_binary_operation(pk, first, _CT_CODEC, second,
                                          _CT_CODEC)
        code, out = agree(apps, "add_cipheru64_cipheru64", data)
        assert code == 0 and Ciphertext.from_bytes(out).size == 3
        assert agree(apps, "mul_cipheru64_cipheru64", data)[0] == 7


def test_foreign_parameters_and_out_of_range_residues(apps, user_keys):
    pk, _ = user_keys
    a = enc(apps, 3, "u64", pk, b"fa")
    # a ciphertext with a residue equal to its modulus: refused at load (3)
    over = Ciphertext(P, a.data.copy())
    over.data[1, 0, 11] = P.ct_moduli[0]
    w = Writer()
    keyio.write_params(w, P)
    w.u64(1)
    w.byte_vec(SealCiphertextBlob(
        compute_parms_id(N, P.ct_moduli, P.t), False, N, K,
        over.data).to_stream())
    over_bytes = w.getvalue()
    data = pack.pack_binary_operation(pk, over_bytes, pack.BYTES, a,
                                      _CT_CODEC)
    for op in ("add", "mul"):
        assert agree(apps, f"{op}_cipheru64_cipheru64", data)[0] == 3
    assert agree(apps, "decrypt_u64",
                 pack.pack_one_argument(over_bytes, pack.BYTES))[0] == 3
    # a ciphertext under another (valid) parameter set: 7 / 5
    other = dataclasses.replace(P, plain_modulus=8192)
    foreign = Ciphertext(other, a.data.copy())
    data = pack.pack_binary_operation(pk, foreign, _CT_CODEC, a, _CT_CODEC)
    assert agree(apps, "add_cipheru64_cipheru64", data)[0] == 7
    assert agree(apps, "decrypt_u64", pack.pack_one_argument(
        foreign, _CT_CODEC))[0] == 5
    # a public key whose relin keys carry other parameters: 7
    rk_other = dataclasses.replace(pk.relin, params=other)
    pk_other = dataclasses.replace(pk, relin=rk_other)
    data = pack.pack_binary_operation(pk_other, a, _CT_CODEC, a, _CT_CODEC)
    assert agree(apps, "mul_cipheru64_cipheru64", data)[0] == 7
    # random bytes through every precompile
    rng = np.random.default_rng(12)
    junk = rng.bytes(300)
    for name in PRECOMPILE_NAMES[::6]:
        agree(apps, name, junk)


def test_galois_bearing_pk_accepted(apps, user_keys):
    pk, sk = user_keys
    raw = pk.to_bytes()
    r = Reader(raw)
    params = keyio.read_params(r)
    pk_stream = r.byte_vec()
    assert not r.option()
    rest = raw[r.off:]
    w = Writer()
    keyio.write_params(w, params)
    w.byte_vec(pk_stream)
    w.option(True)
    keyio.write_params(w, params)
    w.byte_vec(b"\x00" * 32)
    w.raw(rest)
    loaded = keyio.load_public_key(w.getvalue())
    a = enc(apps, 6, "u64", loaded, b"gal")
    data = pack.pack_binary_operation(loaded, a, _CT_CODEC, a, _CT_CODEC)
    code, out = agree(apps, "add_cipheru64_cipheru64", data)
    assert code == 0
    assert PLAIN_TYPES["u64"].decode(apps["golden"].ctx.decrypt(
        Ciphertext.from_bytes(out), sk), P) == 12


# ---------------------------------------------------------------------------
# SEAL zero-extension add/sub for any component count (test_size_semantics)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "sub"])
def test_mismatched_sizes(apps, op):
    name = f"{op}_cipheru64_cipheru64"
    pk = apps["golden"].public_key
    for sa in (1, 2, 3):
        for sb in (1, 2, 3):
            a, b = rand_ct(sa, 10 * sa + sb), rand_ct(sb, 100 + sb)
            data = pack.pack_binary_operation(pk, a, _CT_CODEC, b, _CT_CODEC)
            code, out = agree(apps, name, data)
            assert code == 0
            assert Ciphertext.from_bytes(out).size == max(sa, sb)


def test_zero_extension_against_plaintexts(apps):
    g = apps["golden"]
    sk = g.private_key

    def ct(v, tag):
        return enc(apps, v, "u64", g.public_key, tag)

    prod3 = g.ctx.multiply(ct(6, b"za"), ct(7, b"zb"))       # size 3, 42
    c2 = ct(100, b"zc")
    for e in ("golden", "torch"):
        eng = apps[e]._engine
        dec = lambda c: PLAIN_TYPES["u64"].decode(g.ctx.decrypt(c, sk), P)
        s = eng.add(Ciphertext(P, prod3.data.copy()), c2)
        assert s.size == 3 and dec(s) == 142, e
        d = eng.sub(c2, Ciphertext(P, prod3.data.copy()))
        assert d.size == 3 and dec(d) == 58, e
        assert dec(eng.add(c2, Ciphertext(P, prod3.data.copy()))) == 142, e


@pytest.mark.parametrize("size", [1, 3, 5])
def test_odd_sizes_through_plain_ops_and_decrypt(apps, size):
    pk = apps["golden"].public_key
    ct = rand_ct(size, 500 + size)
    data = pack.pack_binary_operation(pk, ct, _CT_CODEC, 5, pack.U64)
    for name in ("add_cipheru64_u64", "sub_cipheru64_u64",
                 "mul_cipheru64_u64"):
        assert agree(apps, name, data)[0] == 0
    data = pack.pack_binary_operation(pk, 5, pack.U64, ct, _CT_CODEC)
    for name in ("sub_u64_cipheru64", "mul_u64_cipheru64"):
        assert agree(apps, name, data)[0] == 0
    code = agree(apps, "decrypt_frac64",
                 pack.pack_one_argument(ct.to_bytes(), pack.BYTES))[0]
    assert code == (5 if size == 1 else 0)
    add_in = pack.pack_binary_operation(pk, ct, _CT_CODEC, rand_ct(2, 902),
                                        _CT_CODEC)
    assert agree(apps, "add_cipheru64_cipheru64", add_in)[0] == 0


def test_reencrypt_to_relinless_target_pk(apps):
    g = apps["golden"]
    pk1, _ = g.ctx.generate_keys(seed=b"\x61" * 64)
    ct = enc(apps, 7, "u64", g.public_key, b"rr")
    data = pack.pack_binary_operation(dataclasses.replace(pk1, relin=None),
                                      ct, _CT_CODEC, b"\x05", pack.BYTES)
    assert agree(apps, "reencrypt_u64", data)[0] == 0


# ---------------------------------------------------------------------------
# decrypt on adversarial ciphertexts (test_decrypt_consensus)
# ---------------------------------------------------------------------------

def _const_poly_ct(x: int, coeff: int = 0) -> bytes:
    """c1 = 0 and c0 with CRT value x at one coefficient: dot == x there."""
    data = np.zeros((2, K, N), dtype=np.uint64)
    for j, p in enumerate(P.ct_moduli):
        data[0, j, coeff] = x % p
    return Ciphertext(P, data).to_bytes()


def _boundary_dots():
    q, t = P.q, P.t
    xs = [VERDICT_DOT]
    for m in (0, 1, 5, t // 2, t - 1, t):
        base = m * q - q // 2
        for d in (-1, 0, 1):
            x = (base + d) // t
            if 0 <= x < q:
                xs.append(x)
    return xs


@pytest.mark.parametrize("tname", TYPES)
def test_c1_zero_boundary_dots(apps, tname):
    for x in _boundary_dots():
        agree(apps, f"decrypt_{tname}",
              pack.pack_one_argument(_const_poly_ct(x), pack.BYTES))


def test_boundary_dots_at_high_coefficients(apps):
    for coeff in (1, 63, N - 1):
        for x in _boundary_dots()[:5]:
            agree(apps, "decrypt_frac64", pack.pack_one_argument(
                _const_poly_ct(x, coeff), pack.BYTES))


def test_garbage_and_wrong_key_ciphertexts(apps):
    for trial, size in enumerate((3, 3, 2, 2)):
        blob = rand_ct(size, 7000 + trial).to_bytes()
        for tname in ("frac64", "u64"):
            agree(apps, f"decrypt_{tname}",
                  pack.pack_one_argument(blob, pack.BYTES))
    ctx = apps["golden"].ctx
    pk, _ = ctx.generate_keys(seed=b"\x5a" * 64)
    ct = ctx.encrypt(encode_frac64(3.25, P), pk, b"\x11" * 64)
    for tname in TYPES:
        agree(apps, f"decrypt_{tname}",
              pack.pack_one_argument(ct.to_bytes(), pack.BYTES))


def test_reencrypt_boundary_ciphertexts(apps):
    for x in _boundary_dots()[:4]:
        ct = Ciphertext.from_bytes(_const_poly_ct(x))
        data = pack.pack_binary_operation(apps["golden"].public_key, ct,
                                          _CT_CODEC, b"\x01\x02", pack.BYTES)
        agree(apps, "reencrypt_i64", data)


# ---------------------------------------------------------------------------
# the checked-in fuzz corpus: [op index][calldata]
# ---------------------------------------------------------------------------

def test_fuzz_corpus_replay(apps):
    seeds = sorted(os.listdir(SEED_DIR))
    assert len(seeds) == 132, "fuzz corpus missing"
    codes = {}
    for fname in seeds:
        with open(os.path.join(SEED_DIR, fname), "rb") as f:
            raw = f.read()
        if not raw:
            continue
        name = PRECOMPILE_NAMES[raw[0] % len(PRECOMPILE_NAMES)]
        code, _ = agree(apps, name, raw[1:])
        codes[code] = codes.get(code, 0) + 1
    assert codes.get(0) and len(codes) > 2, codes


def test_chip_smoke_error_cases_give_the_jax_golden_codes(apps, user_keys):
    """The invalid inputs that ``chip_smoke.py`` phase app sends to the card
    carry the codes the JAX package's golden app gives them."""
    import chip_smoke
    g = apps["golden"]
    name = "mul_cipheru64_cipheru64"
    calldata = {name: chip_smoke.app_calldata(g, user_keys[0], name)}
    cases = chip_smoke.app_error_cases(g, user_keys, calldata)
    assert len(cases) >= 12
    for label, op, data, code in cases:
        assert agree(apps, op, data)[0] == code, label

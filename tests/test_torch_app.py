"""The port's ``FheApp`` against the JAX package's golden ``FheApp``.

All 49 precompiles through the port's two engines -- ``"golden"`` and
``"torch"`` on the CPU, where every kernel wrapper runs its plain version --
give the bytes and codes of the JAX package's golden app (tolerance 0:
exact bytes).  Calldata is built with the port's own ``pack`` and golden
encryptor and held equal to the JAX package's.  Also: the pinned hashes of
``tests/data/golden_hashes.json``, the ``testnet.two-candidate`` preset on
generated network keys, the engines and devices ``FheApp`` and
``testnet.one`` accept, and ``metrics``.
"""
import hashlib
import json
import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from fhe_precompiles_tpu import FheApp as JFheApp
from fhe_precompiles_tpu import metrics as j_metrics
from fhe_precompiles_tpu import pack as j_pack
from fhe_precompiles_tpu.app import _CT_CODEC as J_CT_CODEC
from fhe_precompiles_tpu.app import PRECOMPILE_NAMES as J_PRECOMPILE_NAMES
from fhe_precompiles_tpu.bfv.golden import BfvContext as JBfvContext
from fhe_precompiles_tpu.encoding import PLAIN_TYPES as J_PLAIN_TYPES
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE
from fhe_precompiles_tpu.params import TESTNET_TWO_CANDIDATE as J_TWO
from fhe_precompiles_tpu.serialization import keyio as j_keyio

from fhe_precompiles_tpu_torch import (FheApp, PRECOMPILE_NAMES, metrics,
                                       pack, testnet)
from fhe_precompiles_tpu_torch.app import _CT_CODEC
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.params import (TESTNET_ONE,
                                              TESTNET_TWO_CANDIDATE)

SCALARS = {"u256": pack.U256, "u64": pack.U64, "i64": pack.I64,
           "frac64": pack.FRAC64}
J_SCALARS = {"u256": j_pack.U256, "u64": j_pack.U64, "i64": j_pack.I64,
             "frac64": j_pack.FRAC64}
ENGINES = ("golden", "torch")
GOLDEN_HASHES = os.path.join(os.path.dirname(__file__), "data",
                             "golden_hashes.json")


@pytest.fixture(scope="module")
def apps():
    """The JAX package's golden app and the port's two, on the embedded
    network keys."""
    return {"jax_golden": JFheApp(J_ONE),
            "golden": FheApp(TESTNET_ONE),
            "torch": FheApp(TESTNET_ONE, engine="torch", device="cpu")}


@pytest.fixture(scope="module")
def user_keys():
    return BfvContext(TESTNET_ONE).generate_keys(seed=b"\x31" * 64)


def _value(tname, x):
    return float(x) if tname == "frac64" else x


class _Encoder:
    """A plain type bound to its parameters (each package has its own)."""

    def __init__(self, plain_type, params):
        self.plain_type, self.params = plain_type, params

    def encode(self, value):
        return self.plain_type.encode(value, self.params)


def inputs_for(name, user_pk, net_pk, encrypt, plain_types, codecs, ct_codec,
               pack_module):
    """Valid calldata for any precompile (``test_consensus_49._inputs_for``),
    with the given package's pack module, encryptor and codecs."""
    kind, _, rest = name.partition("_")
    if name == "public_key_bytes":
        return b""
    if kind in ("encrypt", "reencrypt", "decrypt"):
        scalar = codecs[rest]
        if kind == "encrypt":
            return pack_module.pack_two_arguments(_value(rest, 12), scalar,
                                          b"\x01\x02\x03", pack_module.BYTES)
        ct = encrypt(plain_types[rest].encode(_value(rest, 12)), net_pk,
                     hashlib.sha512(name.encode()).digest())
        if kind == "decrypt":
            return pack_module.pack_one_argument(ct, ct_codec)
        return pack_module.pack_binary_operation(user_pk, ct, ct_codec,
                                         b"\x01\x02\x03", pack_module.BYTES)
    op, a_t, b_t = name.split("_")
    tname = a_t.replace("cipher", "")

    def arg(tag, v, cipher):
        if not cipher:
            return _value(tname, v), codecs[tname]
        seed = hashlib.sha512((name + tag).encode()).digest()
        return encrypt(plain_types[tname].encode(_value(tname, v)), user_pk,
                       seed), ct_codec
    a, ca = arg("a", 16, a_t.startswith("cipher"))
    b, cb = arg("b", 4, b_t.startswith("cipher"))
    return pack_module.pack_binary_operation(user_pk, a, ca, b, cb)


@pytest.fixture(scope="module")
def calldata(apps, user_keys):
    """Calldata of every precompile, built with the port's pack and golden
    encryptor."""
    g = apps["golden"]
    types = {t: _Encoder(pt, TESTNET_ONE) for t, pt in PLAIN_TYPES.items()}
    return {name: inputs_for(name, user_keys[0], g.public_key, g.ctx.encrypt,
                             types, SCALARS, _CT_CODEC, pack)
            for name in PRECOMPILE_NAMES}


def test_precompile_names_are_the_jax_packages():
    assert PRECOMPILE_NAMES == J_PRECOMPILE_NAMES
    assert len(PRECOMPILE_NAMES) == 49
    for name in PRECOMPILE_NAMES:
        assert callable(getattr(FheApp, name))


def test_calldata_built_by_the_port_equals_the_jax_packages(apps, user_keys,
                                                            calldata):
    jg = apps["jax_golden"]
    j_pk = j_keyio.load_public_key(user_keys[0].to_bytes())
    types = {t: _Encoder(pt, J_ONE) for t, pt in J_PLAIN_TYPES.items()}
    for name in PRECOMPILE_NAMES:
        want = inputs_for(name, j_pk, jg.public_key, jg.ctx.encrypt, types,
                          J_SCALARS, J_CT_CODEC, j_pack)
        assert calldata[name] == want, name


def _expected(name):
    """The plaintext a successful call's output holds: 16 op 4, or 12."""
    kind, _, rest = name.partition("_")
    if kind in ("encrypt", "reencrypt", "decrypt"):
        return rest, 12
    op, a_t, _ = name.split("_")
    tname = a_t.replace("cipher", "")
    return tname, {"add": 20, "sub": 12, "mul": 64}[op]


@pytest.mark.parametrize("name", PRECOMPILE_NAMES)
def test_op_bytes_equal_to_the_jax_golden_app(apps, user_keys, calldata,
                                              name):
    data = calldata[name]
    outs = {e: app.call(name, data) for e, app in apps.items()}
    code, out = outs["jax_golden"]
    assert code == 0, name
    for e in ENGINES:
        assert outs[e] == (code, out), f"{name}: {e} differs"
    if name == "public_key_bytes":
        assert out == apps["golden"]._public_key_bytes
        return
    tname, value = _expected(name)
    kind = name.partition("_")[0]
    g = apps["golden"]
    if kind == "decrypt":
        got = SCALARS[tname].deserialize(out)
    else:
        sk = g.private_key if kind == "encrypt" else user_keys[1]
        got = PLAIN_TYPES[tname].decode(
            g.ctx.decrypt(Ciphertext.from_bytes(out), sk), TESTNET_ONE)
    assert got == _value(tname, value), name


@pytest.mark.parametrize("engine", ENGINES)
def test_pinned_golden_hashes(apps, engine):
    with open(GOLDEN_HASHES) as f:
        pinned = json.load(f)
    app = apps[engine]
    enc_in = pack.pack_two_arguments(12, pack.U256, b"\x01\x02\x03",
                                     pack.BYTES)
    ct_bytes = app.encrypt_u256(enc_in)
    assert (hashlib.sha512(ct_bytes).hexdigest()
            == pinned["encrypt_u256_12_010203"])
    re_in = pack.pack_binary_operation(app.public_key,
                                       Ciphertext.from_bytes(ct_bytes),
                                       _CT_CODEC, b"\x01\x02\x03", pack.BYTES)
    assert (hashlib.sha512(app.reencrypt_u256(re_in)).hexdigest()
            == pinned["refresh_u256_12_010203"])


def test_noise_budget_equal(apps, calldata):
    ct = apps["golden"].encrypt_u64(calldata["encrypt_u64"])
    want = apps["jax_golden"].noise_budget(ct)
    assert want > 0
    for e in ENGINES:
        assert apps[e].noise_budget(ct) == want


# ---------------------------------------------------------------------------
# testnet.two-candidate (n = 8192, k = 3) on generated network keys
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_apps():
    pk, sk = JBfvContext(J_TWO).generate_keys(seed=b"\x77" * 64)
    pub, pri = j_keyio.save_public_key(pk), j_keyio.save_private_key(sk)
    return {"jax_golden": JFheApp(J_TWO, pub, pri),
            "golden": FheApp(TESTNET_TWO_CANDIDATE, pub, pri),
            "torch": FheApp(TESTNET_TWO_CANDIDATE, pub, pri, engine="torch",
                            device="cpu")}


def _identical(apps, name, data):
    outs = {e: app.call(name, data) for e, app in apps.items()}
    assert len(set(outs.values())) == 1, (
        name, {e: (c, len(p)) for e, (c, p) in outs.items()})
    return outs["jax_golden"]


def test_two_candidate_threshold_round_trip(two_apps):
    enc_in = pack.pack_two_arguments(123456789, pack.U64, b"t2", pack.BYTES)
    code, ct = _identical(two_apps, "encrypt_u64", enc_in)
    assert code == 0
    code, out = _identical(two_apps, "decrypt_u64",
                           pack.pack_one_argument(ct, pack.BYTES))
    assert code == 0 and int.from_bytes(out, "big") == 123456789


def test_two_candidate_mul_and_mixed_sizes(two_apps):
    g = two_apps["golden"]

    def ct(v, tag):
        return g.ctx.encrypt(PLAIN_TYPES["u64"].encode(v, g.params),
                             g.public_key, hashlib.sha512(tag).digest())

    a, b = ct(1234567, b"a"), ct(89, b"b")
    data = pack.pack_binary_operation(g.public_key, a, _CT_CODEC, b,
                                      _CT_CODEC)
    code, out = _identical(two_apps, "mul_cipheru64_cipheru64", data)
    assert code == 0
    code, val = _identical(two_apps, "decrypt_u64",
                           pack.pack_one_argument(out, pack.BYTES))
    assert int.from_bytes(val, "big") == 1234567 * 89
    c3 = g.ctx.multiply(a, b)
    data3 = pack.pack_binary_operation(g.public_key, c3, _CT_CODEC, a,
                                       _CT_CODEC)
    assert _identical(two_apps, "sub_cipheru64_cipheru64", data3)[0] == 0


def test_two_candidate_boundary_dots(two_apps):
    params = TESTNET_TWO_CANDIDATE
    k, n, q, t = len(params.ct_moduli), params.n, params.q, params.t
    xs = [0, q - 1]
    for m in (0, 1, t // 2, t - 1):
        for d in (-1, 0, 1):
            x = (m * q - q // 2 + d) // t
            if 0 <= x < q:
                xs.append(x)
    data = np.zeros((2, k, n), dtype=np.uint64)
    for j, p in enumerate(params.ct_moduli):
        data[0, j, :len(xs)] = [x % p for x in xs]
    blob = Ciphertext(params, data).to_bytes()
    for tname in ("i64", "frac64"):
        _identical(two_apps, f"decrypt_{tname}",
                   pack.pack_one_argument(blob, pack.BYTES))


# ---------------------------------------------------------------------------
# engines, devices, testnet.one, metrics
# ---------------------------------------------------------------------------

def test_engines_and_devices():
    golden = FheApp(TESTNET_ONE)
    assert isinstance(golden._engine, BfvContext)
    on_cpu = FheApp(TESTNET_ONE, engine="torch", device="cpu")
    assert isinstance(on_cpu._engine, TorchEngine)
    assert on_cpu._engine.device.type == "cpu"
    # "native": the C++ host engine on the CPU, named by the caller
    on_host = FheApp(TESTNET_ONE, engine="native")
    assert type(on_host._engine).__name__ == "NativeEngine"
    for bad in ("jax", "cuda", ""):
        with pytest.raises(ValueError, match="unknown engine"):
            FheApp(TESTNET_ONE, engine=bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FheApp(TESTNET_ONE, engine="torch")


def test_testnet_one_is_the_torch_engine_on_the_card():
    one = testnet.one
    assert one.PARAMS == TESTNET_ONE
    assert "FHE" not in vars(one)          # importing built no app
    if torch.cuda.is_available():
        assert one.FHE._engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        one.FHE
    assert "FHE" not in vars(one)
    pk, sk = one.generate_keys()
    assert pk.params == TESTNET_ONE and pk.relin is not None
    assert type(pk).from_bytes(pk.to_bytes()).to_bytes() == pk.to_bytes()


def test_metrics_registry_as_the_jax_packages():
    regs = (metrics.MetricsRegistry(), j_metrics.MetricsRegistry())
    for reg in regs:
        with reg.measure("a", 10):
            pass
        with pytest.raises(KeyError):
            with reg.measure("a", 5):
                raise KeyError
        reg.record_output("a", 7)
        reg.record_batch("b", 3, 0.5, 1, 2, 1)
    snaps = [{k: (s.count, s.errors, s.bytes_in, s.bytes_out)
              for k, s in reg.snapshot().items()} for reg in regs]
    assert snaps[0] == snaps[1] == {"a": (1, 1, 10, 7), "b": (3, 1, 1, 2)}
    assert not metrics.GLOBAL.enabled
    metrics.enable()
    try:
        app = FheApp(TESTNET_ONE)
        app.call("public_key_bytes", b"")
        app.call("decrypt_u64", b"junk")
        stats = metrics.GLOBAL.snapshot()
        assert stats["public_key_bytes"].count == 1
        assert stats["public_key_bytes"].bytes_out == len(
            app._public_key_bytes)
        assert stats["decrypt_u64"].errors == 1
    finally:
        metrics.disable()
        metrics.GLOBAL.reset()

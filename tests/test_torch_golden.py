"""The port's copied host model (params, sampling, BfvContext) against the
JAX package's: equal presets and derived constants, equal keys from the same
seed, equal encrypt bytes, equal multiply / relinearize bytes, equal
elementwise operations (SEAL's zero-extension included) and an equal noise
budget.  Exact: ``np.array_equal`` / ``==`` throughout.
"""
import numpy as np
import pytest

from fhe_precompiles_tpu import params as jp
from fhe_precompiles_tpu import sampling as js
from fhe_precompiles_tpu.bfv import BfvContext as JaxBfvContext
from fhe_precompiles_tpu.bfv import Ciphertext as JaxCiphertext
from fhe_precompiles_tpu.bfv import RelinKeys as JaxRelinKeys

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import params as tp
from fhe_precompiles_tpu_torch import sampling as ts
from fhe_precompiles_tpu_torch.bfv import BfvContext, Ciphertext

SEED = b"\x21" * 64


@pytest.mark.parametrize("name", sorted(jp.PRESETS))
def test_presets_and_behz_base_equal(name):
    a, b = jp.PRESETS[name], tp.PRESETS[name]
    assert sorted(tp.PRESETS) == sorted(jp.PRESETS)
    for field in ("poly_modulus_degree", "coeff_modulus", "plain_modulus",
                  "scheme_type", "security_level", "ct_moduli", "key_moduli",
                  "special_modulus", "q", "delta", "aux_moduli", "m_sk",
                  "m_tilde", "bsk_moduli", "gamma"):
        assert getattr(a, field) == getattr(b, field), field
    b.validate()


def _same(x, y):
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, np.ndarray):
        return np.array_equal(x, y)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(u, v) for u, v in zip(x, y))
    return x == y


@pytest.mark.parametrize("name", ["testnet.one", "bench.n8192"])
def test_derived_constants_equal(name):
    a, b = JaxBfvContext(jp.PRESETS[name]), BfvContext(tp.PRESETS[name])
    for field in ("n", "t", "q_mods", "key_mods", "k", "k_key", "q",
                  "delta_mod_q", "q_mod_t", "q_hat", "q_hat_inv", "P",
                  "P_half", "inv_P_mod_q", "P_mod_q", "B", "m_sk", "m_tilde",
                  "Bsk", "q_hat_mod_x", "q_mod_x", "mtilde_mod_q",
                  "neg_inv_q_mod_mtilde", "inv_mtilde_mod_x", "inv_q_mod_x",
                  "prod_B", "b_hat", "b_hat_inv", "b_hat_mod_x",
                  "prod_B_mod_q", "inv_prod_B_mod_msk"):
        assert _same(getattr(a, field), getattr(b, field)), field
    for p in a.tables:
        assert np.array_equal(a.tables[p].root_powers,
                              b.tables[p].root_powers)
        assert np.array_equal(a.tables[p].inv_root_powers,
                              b.tables[p].inv_root_powers)
        assert a.tables[p].n_inv == b.tables[p].n_inv


def test_sampling_streams_equal():
    for dom in (js.DOMAIN_TERNARY, js.DOMAIN_ERROR, js.DOMAIN_UNIFORM):
        assert (js.Blake2Xof(SEED, dom).read(1000)
                == ts.Blake2Xof(SEED, dom).read(1000))
    p = jp.TESTNET_ONE.coeff_modulus[0]
    assert np.array_equal(
        js.sample_uniform_mod(js.Blake2Xof(SEED, 1), p, 512),
        ts.sample_uniform_mod(ts.Blake2Xof(SEED, 1), p, 512))
    assert np.array_equal(js.sample_ternary(js.Blake2Xof(SEED, 2), 512),
                          ts.sample_ternary(ts.Blake2Xof(SEED, 2), 512))
    assert np.array_equal(js.sample_cbd(js.Blake2Xof(SEED, 3), 512),
                          ts.sample_cbd(ts.Blake2Xof(SEED, 3), 512))


@pytest.fixture(scope="module")
def both():
    a, b = JaxBfvContext(jp.TESTNET_ONE), BfvContext(tp.TESTNET_ONE)
    return a, b, a.generate_keys(seed=SEED), b.generate_keys(seed=SEED)


def test_keys_equal_from_same_seed(both):
    _, _, (pk_a, sk_a), (pk_b, sk_b) = both
    assert np.array_equal(pk_a.data, pk_b.data)
    assert np.array_equal(pk_a.relin.data, pk_b.relin.data)
    assert np.array_equal(sk_a.s_ntt, sk_b.s_ntt)
    assert np.array_equal(sk_a.s_coeff, sk_b.s_coeff)


def test_encrypt_decrypt_bytes_equal(both):
    a, b, (pk_a, sk_a), (pk_b, sk_b) = both
    rng = np.random.default_rng(5)
    m = rng.integers(0, a.t, size=a.n, dtype=np.uint64)
    ct_a = a.encrypt(m, pk_a, b"\x07" * 64)
    ct_b = b.encrypt(m, pk_b, b"\x07" * 64)
    assert np.array_equal(ct_a.data, ct_b.data)
    assert np.array_equal(b.decrypt(ct_b, sk_b), m)
    assert np.array_equal(a.decrypt(ct_a, sk_a), b.decrypt(ct_b, sk_b))


def test_multiply_relinearize_bytes_equal(both):
    a, b, (pk_a, sk_a), (pk_b, sk_b) = both
    m1 = np.zeros(a.n, dtype=np.uint64)
    m2 = np.zeros(a.n, dtype=np.uint64)
    m1[:3], m2[:2] = [3, 1, 4], [5, 9]
    x_a, y_a = (a.encrypt(m, pk_a, s) for m, s in
                ((m1, b"\x01" * 64), (m2, b"\x02" * 64)))
    x_b, y_b = (b.encrypt(m, pk_b, s) for m, s in
                ((m1, b"\x01" * 64), (m2, b"\x02" * 64)))
    prod_a, prod_b = a.multiply(x_a, y_a), b.multiply(x_b, y_b)
    assert np.array_equal(prod_a.data, prod_b.data)
    out_a = a.relinearize(prod_a, pk_a.relin)
    out_b = b.relinearize(prod_b, pk_b.relin)
    assert np.array_equal(out_a.data, out_b.data)
    assert np.array_equal(
        b.mul_relin(x_b, y_b, pk_b.relin).data,
        a.mul_relin(JaxCiphertext(jp.TESTNET_ONE, x_b.data),
                    JaxCiphertext(jp.TESTNET_ONE, y_b.data),
                    JaxRelinKeys(jp.TESTNET_ONE, pk_b.relin.data)).data)
    want = np.zeros(a.n, dtype=np.uint64)
    want[:4] = [15, 32, 29, 36]                 # (3+x+4x^2)(5+9x)
    assert np.array_equal(b.decrypt(out_b, sk_b), want)


def test_size_checks_raise(both):
    _, b, _, (pk_b, _) = both
    m = np.zeros(b.n, dtype=np.uint64)
    ct = b.encrypt(m, pk_b, b"\x03" * 64)
    with pytest.raises(ValueError):
        b.relinearize(ct, pk_b.relin)
    with pytest.raises(ValueError):
        b.multiply(b.multiply(ct, ct), ct)


# ----------------------------------------------------------------------
# elementwise operations and the noise-budget meter
# ----------------------------------------------------------------------
GOLDEN_OPS = {
    "add": lambda g, x, y, m: g.add(x, y),
    "sub": lambda g, x, y, m: g.sub(x, y),
    "negate": lambda g, x, y, m: g.negate(x),
    "add_plain": lambda g, x, y, m: g.add_plain(x, m),
    "sub_plain": lambda g, x, y, m: g.sub_plain(x, m),
    "plain_sub": lambda g, x, y, m: g.plain_sub(m, x),
    "mul_plain": lambda g, x, y, m: g.mul_plain(x, m),
}


@pytest.fixture(scope="module")
def operands(both):
    a, b, (pk_a, _), _ = both
    rng = np.random.default_rng(9)
    m = rng.integers(0, a.t, size=(3, a.n), dtype=np.uint64)
    cts = [a.encrypt(m[i], pk_a, bytes([i + 9]) * 64).data for i in range(2)]
    return cts, m[2], rng


@pytest.mark.parametrize("op", sorted(GOLDEN_OPS))
def test_elementwise_op_bytes_equal(both, operands, op):
    a, b, _, _ = both
    (x, y), m, _ = operands
    want = GOLDEN_OPS[op](a, JaxCiphertext(jp.TESTNET_ONE, x),
                          JaxCiphertext(jp.TESTNET_ONE, y), m)
    got = GOLDEN_OPS[op](b, Ciphertext(tp.TESTNET_ONE, x),
                         Ciphertext(tp.TESTNET_ONE, y), m)
    assert isinstance(got, Ciphertext)
    assert np.array_equal(got.data, want.data)


@pytest.mark.parametrize("sizes", [(1, 3), (3, 2), (2, 2)])
def test_ext_addsub_bytes_equal_over_unequal_sizes(both, operands, sizes):
    a, b, _, _ = both
    _, _, rng = operands
    data = []
    for size in sizes:
        d = np.empty((size, a.k, a.n), dtype=np.uint64)
        for j, p in enumerate(a.q_mods):
            d[:, j] = rng.integers(0, p, size=(size, a.n), dtype=np.uint64)
        data.append(d)
    for name in ("add", "sub"):
        want = getattr(a, name)(*(JaxCiphertext(jp.TESTNET_ONE, d)
                                  for d in data))
        got = getattr(b, name)(*(Ciphertext(tp.TESTNET_ONE, d)
                                 for d in data))
        assert got.size == max(sizes)
        assert np.array_equal(got.data, want.data)
    with pytest.raises(ValueError):
        b.add(Ciphertext(tp.TESTNET_ONE, data[0][:0]),
              Ciphertext(tp.TESTNET_ONE, data[1]))


def test_noise_budget_bits_equal(both, operands):
    a, b, (pk_a, sk_a), (pk_b, sk_b) = both
    (x, y), _, _ = operands
    fresh_a = a.noise_budget_bits(JaxCiphertext(jp.TESTNET_ONE, x), sk_a)
    fresh_b = b.noise_budget_bits(Ciphertext(tp.TESTNET_ONE, x), sk_b)
    assert fresh_a == fresh_b and fresh_b > 20
    prod = b.mul_relin(Ciphertext(tp.TESTNET_ONE, x),
                       Ciphertext(tp.TESTNET_ONE, y), pk_b.relin)
    used_b = b.noise_budget_bits(prod, sk_b)
    assert used_b == a.noise_budget_bits(
        JaxCiphertext(jp.TESTNET_ONE, prod.data), sk_a)
    assert 0 < used_b < fresh_b


def test_uint128_helpers_equal():
    from fhe_precompiles_tpu.bfv import uint128 as ja
    from fhe_precompiles_tpu_torch.bfv import uint128 as ta
    rng = np.random.default_rng(10)
    y = rng.integers(0, 1 << 37, size=64, dtype=np.uint64)
    c = (1 << 70) + 12345
    for mod in (ja, ta):
        acc = mod.add(mod.zeros(64), mod.mul_const(y, c))
        hi, lo = acc
        assert [(int(h) << 64) | int(v) for h, v in zip(hi, lo)] == [
            int(v) * c for v in y]
    x1, x2 = ja.mul_const(y, c), ta.mul_const(y, c)
    assert all(np.array_equal(u, v) for u, v in zip(x1, x2))
    assert ja.max_value(x1) == ta.max_value(x2) == int(y.max()) * c

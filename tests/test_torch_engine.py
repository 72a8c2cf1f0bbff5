"""The first slice of the PyTorch port as a whole: ``TorchEngine`` on the CPU
(plain versions of the kernels) against the JAX package's golden model and
against one eager run of the JAX pair engine.  Exact: every comparison is
``np.array_equal`` on uint64.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fhe_precompiles_tpu
from fhe_precompiles_tpu.bfv import BfvContext as JaxBfvContext
from fhe_precompiles_tpu.bfv import Ciphertext as JaxCiphertext
from fhe_precompiles_tpu.ops.engine import JaxEngine
from fhe_precompiles_tpu.params import BENCH_N8192 as JAX_N8192
from fhe_precompiles_tpu.params import TESTNET_ONE as JAX_TESTNET_ONE
from fhe_precompiles_tpu.serialization import keyio

from fhe_precompiles_tpu_torch import convert
from fhe_precompiles_tpu_torch.bfv import Ciphertext, RelinKeys
from fhe_precompiles_tpu_torch.ops import tail
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine, pad_rows
from fhe_precompiles_tpu_torch.params import BENCH_N8192, TESTNET_ONE

# the suite runs several workers side by side: keep torch to one thread each
torch.set_num_threads(1)

B = 3


def _negacyclic(a, b, t):
    n = a.shape[0]
    full = np.convolve(a.astype(np.int64), b.astype(np.int64))
    out = full[:n].copy()
    out[:n - 1] -= full[n:]
    return np.mod(out, t).astype(np.uint64)


class Case:
    """Real encrypted operands from the JAX package's golden model."""

    def __init__(self, jax_params, params, batch, seed):
        self.g = JaxBfvContext(jax_params)
        self.pk, self.sk = self.g.generate_keys(seed=bytes([seed]) * 64)
        rng = np.random.default_rng(seed)
        self.plains = np.zeros((2 * batch, self.g.n), dtype=np.uint64)
        self.plains[:, :6] = rng.integers(0, 12, size=(2 * batch, 6),
                                          dtype=np.uint64)
        self.cts = [self.g.encrypt(m, self.pk, bytes([i + 1]) * 64)
                    for i, m in enumerate(self.plains)]
        self.batch = batch
        self.eng = TorchEngine(params, device="cpu")
        self.a = convert.ciphertexts_from_numpy(
            [c.data for c in self.cts[:batch]], "cpu", params, check=True)
        self.b = convert.ciphertexts_from_numpy(
            [c.data for c in self.cts[batch:]], "cpu", params, check=True)
        self.rk = convert.relin_keys_from_numpy(self.pk.relin.data, "cpu",
                                                params, check=True)

    def pair(self, i):
        return self.cts[i], self.cts[self.batch + i]


@pytest.fixture(scope="module")
def one():
    return Case(JAX_TESTNET_ONE, TESTNET_ONE, B, 0x21)


def test_multiply_bytes_equal_golden(one):
    out = convert.to_numpy(one.eng._multiply(one.a, one.b))
    assert out.shape == (B, 3, one.g.k, one.g.n) and out.dtype == np.uint64
    for i in range(B):
        assert np.array_equal(out[i], one.g.multiply(*one.pair(i)).data)


def test_relinearize_bytes_equal_golden(one):
    ct3 = [one.g.multiply(*one.pair(i)) for i in range(B)]
    x = convert.ciphertexts_from_numpy([c.data for c in ct3], "cpu",
                                       TESTNET_ONE)
    out = convert.to_numpy(one.eng._relinearize(x, one.rk))
    for i in range(B):
        assert np.array_equal(
            out[i], one.g.relinearize(ct3[i], one.pk.relin).data)


def test_mul_relin_bytes_equal_golden_and_decrypts_to_product(one):
    out = convert.to_numpy(one.eng._mul_relin(one.a, one.b, one.rk))
    for i in range(B):
        x, y = one.pair(i)
        assert np.array_equal(out[i],
                              one.g.mul_relin(x, y, one.pk.relin).data)
        dec = one.g.decrypt(JaxCiphertext(JAX_TESTNET_ONE, out[i]), one.sk)
        assert np.array_equal(
            dec, _negacyclic(one.plains[i], one.plains[B + i], one.g.t))


def test_mul_relin_prepared_bytes_equal_golden(one):
    e = one.eng
    fa, fb = e._prepare(one.a), e._prepare(one.b)
    assert tuple(fa.shape) == (B, 2, e.nb, e.n)
    out = convert.to_numpy(e._mul_relin_prepared(fa, fb, one.rk))
    core = convert.to_numpy(e._mul_core(fa, fb))
    for i in range(B):
        x, y = one.pair(i)
        assert np.array_equal(core[i], one.g.multiply(x, y).data)
        assert np.array_equal(out[i],
                              one.g.mul_relin(x, y, one.pk.relin).data)


def test_mul_relin_n8192_bytes_equal_golden():
    case = Case(JAX_N8192, BENCH_N8192, 1, 0x33)
    out = convert.to_numpy(case.eng._mul_relin(case.a, case.b, case.rk))
    x, y = case.pair(0)
    assert np.array_equal(out[0], case.g.mul_relin(x, y, case.pk.relin).data)


def test_preset_without_special_prime_multiplies_but_does_not_relinearize():
    """bench.n1024 has a single modulus: no key switching."""
    from fhe_precompiles_tpu.params import BENCH_N1024 as JAX_N1024
    from fhe_precompiles_tpu_torch.params import BENCH_N1024
    g = JaxBfvContext(JAX_N1024)
    pk, _ = g.generate_keys(seed=b"\x44" * 64)
    assert pk.relin is None
    m = np.zeros(g.n, dtype=np.uint64)
    m[:2] = [1, 2]
    x, y = g.encrypt(m, pk, b"\x01" * 64), g.encrypt(m, pk, b"\x02" * 64)
    eng = TorchEngine(BENCH_N1024, device="cpu")
    tx = convert.ciphertexts_from_numpy(x.data[None], "cpu", BENCH_N1024)
    ty = convert.ciphertexts_from_numpy(y.data[None], "cpu", BENCH_N1024)
    ct3 = eng._multiply(tx, ty)
    assert np.array_equal(convert.to_numpy(ct3)[0], g.multiply(x, y).data)
    rk = torch.zeros((g.k, 2, g.k_key, g.n), dtype=torch.int64)
    with pytest.raises(ValueError, match="no special prime"):
        eng._relinearize(ct3, rk)


@pytest.fixture(scope="module")
def jax_pair_run(one):
    """One eager run of the JAX pair engine (the configuration whose tail
    the port's kernels replace; "xla" is its plain tail).  Not jitted: the
    pair programs take minutes to compile on a CPU."""
    eng = JaxEngine(JAX_TESTNET_ONE, golden=one.g, ntt_backend="pair",
                    pair_tail="xla")
    x, y = one.pair(0)
    with jax.disable_jit():
        out = eng._mul_relin(jnp.asarray(x.data)[None],
                             jnp.asarray(y.data)[None],
                             jnp.asarray(one.pk.relin.data))
    return np.asarray(out, dtype=np.uint64)


def test_mul_relin_bytes_equal_eager_jax_pair_engine(one, jax_pair_run):
    out = convert.to_numpy(
        one.eng._mul_relin(one.a[:1], one.b[:1], one.rk))
    assert np.array_equal(out, jax_pair_run)


def test_single_ciphertext_protocol(one):
    x, y = one.pair(1)
    tx, ty = (Ciphertext(TESTNET_ONE, c.data) for c in (x, y))
    trk = RelinKeys(TESTNET_ONE, one.pk.relin.data)
    ct3 = one.eng.multiply(tx, ty)
    assert isinstance(ct3, Ciphertext) and ct3.size == 3
    assert np.array_equal(ct3.data, one.g.multiply(x, y).data)
    want = one.g.mul_relin(x, y, one.pk.relin).data
    assert np.array_equal(one.eng.relinearize(ct3, trk).data, want)
    assert np.array_equal(one.eng.mul_relin(tx, ty, trk).data, want)


def test_single_ciphertext_protocol_size_checks(one):
    x, y = one.pair(0)
    tx, ty = (Ciphertext(TESTNET_ONE, c.data) for c in (x, y))
    trk = RelinKeys(TESTNET_ONE, one.pk.relin.data)
    ct3 = one.eng.multiply(tx, ty)
    with pytest.raises(ValueError, match="size-2"):
        one.eng.multiply(ct3, ty)
    with pytest.raises(ValueError, match="size-2"):
        one.eng.mul_relin(tx, ct3, trk)
    with pytest.raises(ValueError, match="size-3"):
        one.eng.relinearize(tx, trk)


def test_reference_network_relin_keys_carried_over(one):
    """The relin keys inside the JAX package's network.pub, loaded by its
    serialization and carried over by convert, relinearize a port product to
    the golden bytes."""
    data_dir = os.path.join(os.path.dirname(fhe_precompiles_tpu.__file__),
                            "data")
    with open(os.path.join(data_dir, "network.pub"), "rb") as f:
        pk = keyio.load_public_key(f.read())
    with open(os.path.join(data_dir, "network.pri"), "rb") as f:
        sk = keyio.load_private_key(f.read())
    g = one.g
    m1 = np.zeros(g.n, dtype=np.uint64)
    m2 = np.zeros(g.n, dtype=np.uint64)
    m1[0], m2[0] = 16, 4
    a = g.encrypt(m1, pk, b"\x06" * 64)
    b = g.encrypt(m2, pk, b"\x07" * 64)
    rk = convert.relin_keys_from_numpy(pk.relin.data, "cpu", TESTNET_ONE,
                                       check=True)
    ta = convert.ciphertexts_from_numpy(a.data[None], "cpu", TESTNET_ONE)
    tb = convert.ciphertexts_from_numpy(b.data[None], "cpu", TESTNET_ONE)
    prod = one.eng._multiply(ta, tb)
    out = convert.to_numpy(one.eng._relinearize(prod, rk))[0]
    assert np.array_equal(out, g.mul_relin(a, b, pk.relin).data)
    dec = g.decrypt(JaxCiphertext(JAX_TESTNET_ONE, out), sk)
    assert dec[0] == 64 and not dec[1:].any()


def test_cpu_path_launches_no_kernel(one):
    tail.reset_launch_counts()
    one.eng._mul_relin(one.a[:1], one.b[:1], one.rk)
    assert set(tail.launch_counts) == set(tail.KERNEL_NAMES)
    assert not any(tail.launch_counts.values())


def test_pad_rows_repeats_row_zero(one):
    x = one.a[:2]
    padded = pad_rows(x, 5)
    assert tuple(padded.shape) == (5,) + tuple(x.shape[1:])
    assert torch.equal(padded[:2], x)
    assert all(torch.equal(padded[i], x[0]) for i in range(2, 5))
    assert pad_rows(x, 2) is x


def test_convert_validates_and_roundtrips(one):
    data = np.stack([c.data for c in one.cts[:2]])
    t = convert.ciphertexts_from_numpy(data, "cpu", TESTNET_ONE, check=True)
    assert t.dtype == torch.int64 and tuple(t.shape) == data.shape
    assert np.array_equal(convert.to_numpy(t), data)
    bad = data.copy()
    bad[0, 0, 1, 5] = TESTNET_ONE.ct_moduli[1]
    with pytest.raises(ValueError, match="below its modulus"):
        convert.ciphertexts_from_numpy(bad, "cpu", TESTNET_ONE, check=True)
    with pytest.raises(ValueError, match="expected"):
        convert.ciphertexts_from_numpy(data[:, :, :1], "cpu", TESTNET_ONE)
    with pytest.raises(TypeError):
        convert.ciphertexts_from_numpy(data.astype(np.int64), "cpu")
    rk = one.pk.relin.data
    with pytest.raises(ValueError, match="expected"):
        convert.relin_keys_from_numpy(rk[:1], "cpu", TESTNET_ONE)
    bad_rk = rk.copy()
    bad_rk[0, 0, 2, 0] = TESTNET_ONE.key_moduli[2]
    with pytest.raises(ValueError, match="below its modulus"):
        convert.relin_keys_from_numpy(bad_rk, "cpu", TESTNET_ONE, check=True)
    with pytest.raises(TypeError):
        convert.to_numpy(t.to(torch.int32))

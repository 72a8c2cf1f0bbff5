"""The PyTorch port's engine as a whole: ``TorchEngine`` on the CPU (plain
versions of the kernels) against the JAX package's golden model, against
``JaxEngine`` with the "stage" NTT, and against one eager run of the JAX pair
engine: multiply and relinearize, encrypt, decrypt, the elementwise
operations, and encrypt -> multiply + relinearize -> decrypt in one piece.
Exact: every comparison is ``np.array_equal`` on uint64.
"""
import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")

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
from fhe_precompiles_tpu_torch.bfv import (Ciphertext, PublicKey, RelinKeys,
                                           SecretKey)
from fhe_precompiles_tpu_torch.ops import ntt as torch_ntt
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
    torch_ntt.reset_launch_counts()
    one.eng._mul_relin(one.a[:1], one.b[:1], one.rk)
    assert set(tail.launch_counts) == set(tail.KERNEL_NAMES)
    assert not any(tail.launch_counts.values())
    assert torch_ntt.launch_counts == {"ntt": 0, "intt": 0}


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


# ----------------------------------------------------------------------
# encrypt, decrypt and the elementwise operations
# ----------------------------------------------------------------------
class Trip:
    """Keys, plaintexts and both engines for one preset: the JAX package's
    golden model and ``JaxEngine`` ("stage" NTT) on one side, the port's
    ``TorchEngine`` on the CPU with the port's key objects on the other."""

    def __init__(self, jax_params, params, batch, seed):
        self.jp, self.params, self.batch = jax_params, params, batch
        self.g = JaxBfvContext(jax_params)
        self.pk, self.sk = self.g.generate_keys(seed=bytes([seed]) * 64)
        self.jax = JaxEngine(jax_params, golden=self.g, ntt_backend="stage")
        self.eng = TorchEngine(params, device="cpu")
        self.tpk = PublicKey(params, self.pk.data)
        self.tsk = SecretKey(params, self.sk.s_ntt)
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.plains = rng.integers(0, self.g.t, size=(batch, self.g.n),
                                   dtype=np.uint64)
        self.seeds = [bytes([i + 1]) * 64 for i in range(batch)]
        self.cts = [self.g.encrypt(m, self.pk, s)
                    for m, s in zip(self.plains, self.seeds)]

    def garbage(self, size):
        """A wire-valid ciphertext of any size with uniform residues."""
        data = np.empty((size, self.g.k, self.g.n), dtype=np.uint64)
        for j, p in enumerate(self.g.q_mods):
            data[:, j] = self.rng.integers(0, p, size=(size, self.g.n),
                                           dtype=np.uint64)
        return data

    def both(self, data):
        return JaxCiphertext(self.jp, data), Ciphertext(self.params, data)


@pytest.fixture(scope="module")
def small():
    from fhe_precompiles_tpu.params import BENCH_N1024 as JAX_N1024
    from fhe_precompiles_tpu_torch.params import BENCH_N1024
    return Trip(JAX_N1024, BENCH_N1024, 3, 0x51)


@pytest.fixture(scope="module")
def one_trip():
    return Trip(JAX_TESTNET_ONE, TESTNET_ONE, 2, 0x52)


def test_encrypt_batch_equals_jax_engine_and_golden(small):
    out = small.eng.encrypt_batch(small.plains, small.tpk, small.seeds)
    assert out.dtype == torch.int64
    assert tuple(out.shape) == (3, 2, small.g.k, small.g.n)
    got = convert.to_numpy(out)
    want = np.asarray(small.jax.encrypt_batch(small.plains, small.pk,
                                              small.seeds), dtype=np.uint64)
    assert np.array_equal(got, want)
    for i in range(3):
        assert np.array_equal(got[i], small.cts[i].data)
    single = small.eng.encrypt(small.plains[1], small.tpk, small.seeds[1])
    assert isinstance(single, Ciphertext)
    assert np.array_equal(single.data, small.cts[1].data)


def test_encrypt_batch_pads_on_the_device(small):
    out = convert.to_numpy(small.eng.encrypt_batch(
        small.plains[:2], small.tpk, small.seeds[:2], target_batch=4))
    assert out.shape[0] == 4
    assert np.array_equal(out[0], small.cts[0].data)
    assert np.array_equal(out[1], small.cts[1].data)
    assert np.array_equal(out[2], out[0]) and np.array_equal(out[3], out[0])


@pytest.mark.parametrize("size", [2, 3, 4])
def test_decrypt_batch_any_size_equals_jax_engine_and_golden(small, size):
    """Real encryptions extended with garbage components, and pure garbage:
    decrypt is defined on every wire-valid ciphertext."""
    rows = [np.concatenate([c.data, small.garbage(size - 2)])
            for c in small.cts[:2]] + [small.garbage(size)]
    data = np.stack(rows)
    got = small.eng.decrypt_batch(
        convert.ciphertexts_from_numpy(data, "cpu", small.params), small.tsk)
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, small.g.n)
    got = convert.to_numpy(got)
    want = np.asarray(small.jax.decrypt_batch(data, small.sk),
                      dtype=np.uint64)
    assert np.array_equal(got, want)
    for i, row in enumerate(rows):
        assert np.array_equal(
            got[i], small.g.decrypt(JaxCiphertext(small.jp, row), small.sk))
    if size == 2:
        assert np.array_equal(got[:2], small.plains[:2])
        padded = small.eng.decrypt_batch(
            convert.ciphertexts_from_numpy(data[:2], "cpu"), small.tsk,
            target_batch=5)
        assert tuple(padded.shape) == (5, small.g.n)
        assert np.array_equal(convert.to_numpy(padded)[:2], got[:2])
        one_ct = small.eng.decrypt(Ciphertext(small.params, rows[2]),
                                   small.tsk)
        assert one_ct.dtype == np.uint64 and np.array_equal(one_ct, got[2])


def test_decrypt_of_size_one_raises(small):
    data = small.garbage(1)[None]
    with pytest.raises(ValueError, match=">= 2 components"):
        small.eng.decrypt_batch(
            convert.ciphertexts_from_numpy(data, "cpu"), small.tsk)
    with pytest.raises(ValueError, match=">= 2 components"):
        small.jax.decrypt_batch(data, small.sk)


def test_decrypt_on_rounding_boundaries_equals_golden(one_trip):
    """c1 = 0 makes the dot product c0 itself; its coefficients sit on and
    beside the boundaries of round(t*x/q)."""
    tr = one_trip
    q, t = tr.g.q, tr.g.t
    xs = [6341038794891017812 % q, 0, q - 1, q // 2]
    for m in (0, 1, 5, t // 2, t - 1, t):
        for d in (-1, 0, 1):
            x = (m * q - q // 2 + d) // t
            if 0 <= x < q:
                xs.append(x)
    data = np.zeros((2, tr.g.k, tr.g.n), dtype=np.uint64)
    for j, p in enumerate(tr.g.q_mods):
        data[0, j, :len(xs)] = [x % p for x in xs]
    jct, tct = tr.both(data)
    got = tr.eng.decrypt(tct, tr.tsk)
    assert np.array_equal(got, tr.g.decrypt(jct, tr.sk))
    assert got[:len(xs)].tolist() == [(t * x + q // 2) // q % t for x in xs]


ELEMENTWISE = {
    "add": lambda e, a, b, m: e.add(a, b),
    "sub": lambda e, a, b, m: e.sub(a, b),
    "negate": lambda e, a, b, m: e.negate(a),
    "add_plain": lambda e, a, b, m: e.add_plain(a, m),
    "sub_plain": lambda e, a, b, m: e.sub_plain(a, m),
    "plain_sub": lambda e, a, b, m: e.plain_sub(m, a),
    "mul_plain": lambda e, a, b, m: e.mul_plain(a, m),
}


@pytest.mark.parametrize("op", sorted(ELEMENTWISE))
def test_elementwise_op_equals_jax_engine_and_golden(small, op):
    """Size-3 first operand: every component takes part."""
    fn = ELEMENTWISE[op]
    ja, ta = small.both(np.concatenate([small.cts[0].data,
                                        small.garbage(1)]))
    jb, tb = small.both(small.cts[1].data)
    m = small.plains[2]
    got = fn(small.eng, ta, tb, m)
    assert isinstance(got, Ciphertext) and got.data.dtype == np.uint64
    assert np.array_equal(got.data, fn(small.g, ja, jb, m).data)
    assert np.array_equal(got.data, fn(small.jax, ja, jb, m).data)


@pytest.mark.parametrize("sizes", [(1, 2), (2, 3), (3, 1), (4, 2), (1, 1)])
def test_ext_addsub_zero_extension_over_unequal_sizes(small, sizes):
    sa, sb = sizes
    ja, ta = small.both(small.garbage(sa))
    jb, tb = small.both(small.garbage(sb))
    for name in ("add", "sub"):
        got = getattr(small.eng, name)(ta, tb)
        assert got.size == max(sa, sb)
        assert np.array_equal(got.data, getattr(small.g, name)(ja, jb).data)
        assert np.array_equal(got.data,
                              getattr(small.jax, name)(ja, jb).data)
    empty = Ciphertext(small.params, small.garbage(2)[:0])
    with pytest.raises(ValueError, match=">= 1"):
        small.eng.add(ta, empty)


def test_batched_elementwise_forms_equal_golden_row_by_row(small):
    e, g = small.eng, small.g
    data = np.stack([c.data for c in small.cts])
    ct = convert.ciphertexts_from_numpy(data, "cpu", small.params)
    m = convert.plaintexts_from_numpy(small.plains, "cpu", small.params,
                                      check=True)
    other = torch.roll(ct, 1, dims=0)
    outs = {
        "add": e._add(ct, other), "sub": e._sub(ct, other),
        "negate": e._neg(ct), "add_plain": e._add_plain(ct, m),
        "sub_plain": e._sub_plain(ct, m), "plain_sub": e._plain_sub(m, ct),
        "mul_plain": e._mul_plain(ct, m),
    }
    for op, out in outs.items():
        assert tuple(out.shape) == tuple(ct.shape), op
        got = convert.to_numpy(out)
        for i in range(3):
            want = ELEMENTWISE[op](g, small.cts[i], small.cts[(i - 1) % 3],
                                   small.plains[i])
            assert np.array_equal(got[i], want.data), (op, i)
    dm = convert.to_numpy(e._scaled_plain(m))
    for i in range(3):
        assert np.array_equal(dm[i], g._scale_plain(small.plains[i]))


def test_testnet_one_encrypt_decrypt_mul_plain_equal_jax_engine(one_trip):
    tr = one_trip
    out = convert.to_numpy(tr.eng.encrypt_batch(tr.plains, tr.tpk, tr.seeds))
    assert np.array_equal(out, np.asarray(
        tr.jax.encrypt_batch(tr.plains, tr.pk, tr.seeds), dtype=np.uint64))
    for i in range(2):
        assert np.array_equal(out[i], tr.cts[i].data)
    data = np.stack([np.concatenate([c.data, tr.garbage(1)])
                     for c in tr.cts])
    got = convert.to_numpy(tr.eng.decrypt_batch(
        convert.ciphertexts_from_numpy(data, "cpu", tr.params), tr.tsk))
    assert np.array_equal(got, np.asarray(tr.jax.decrypt_batch(data, tr.sk),
                                          dtype=np.uint64))
    ja, ta = tr.both(tr.cts[0].data)
    want = tr.g.mul_plain(ja, tr.plains[1]).data
    assert np.array_equal(tr.eng.mul_plain(ta, tr.plains[1]).data, want)
    assert np.array_equal(tr.jax.mul_plain(ja, tr.plains[1]).data, want)


def test_slice_as_a_whole_encrypt_mul_relin_decrypt(one_trip):
    """Encrypt on the engine, multiply + relinearize, decrypt on the engine:
    the plaintexts' negacyclic product, and the host model's bytes on the
    way."""
    tr = one_trip
    plains = np.zeros((2, tr.g.n), dtype=np.uint64)
    plains[:, :5] = tr.rng.integers(0, 12, size=(2, 5), dtype=np.uint64)
    e = tr.eng
    cts = e.encrypt_batch(plains, tr.tpk, tr.seeds)
    other = torch.roll(cts, 1, dims=0)
    rk = convert.relin_keys_from_numpy(tr.pk.relin.data, "cpu", tr.params)
    ct3 = e._multiply(cts, other)
    out = e._mul_relin(cts, other, rk)
    dec2 = convert.to_numpy(e.decrypt_batch(out, tr.tsk))
    dec3 = convert.to_numpy(e.decrypt_batch(ct3, tr.tsk))
    host = [tr.g.encrypt(plains[i], tr.pk, tr.seeds[i]) for i in range(2)]
    for i in range(2):
        want = _negacyclic(plains[i], plains[1 - i], tr.g.t)
        assert np.array_equal(dec2[i], want)
        assert np.array_equal(dec3[i], want)
        assert np.array_equal(
            convert.to_numpy(out)[i],
            tr.g.mul_relin(host[i], host[1 - i], tr.pk.relin).data)


def test_convert_keys_and_plaintexts_validate(one_trip):
    tr, prm = one_trip, TESTNET_ONE
    k = len(prm.ct_moduli)
    pk = convert.public_key_from_numpy(tr.pk.data, "cpu", prm, check=True)
    assert tuple(pk.shape) == (2, len(prm.key_moduli), prm.n)
    pk_ct = convert.public_key_from_numpy(tr.pk.data, "cpu", prm,
                                          ct_limbs_only=True)
    assert np.array_equal(convert.to_numpy(pk_ct), tr.pk.data[:, :k])
    sk = convert.secret_key_from_numpy(tr.sk.s_ntt, "cpu", prm, check=True)
    assert np.array_equal(convert.to_numpy(sk), tr.sk.s_ntt[:k])
    m = convert.plaintexts_from_numpy(tr.plains, "cpu", prm, check=True)
    assert m.dtype == torch.int64
    assert np.array_equal(convert.to_numpy(m), tr.plains)
    assert np.array_equal(
        convert.to_numpy(convert.from_numpy(tr.plains, "cpu")), tr.plains)

    bad = tr.pk.data.copy()
    bad[1, 2, 7] = prm.key_moduli[2]
    with pytest.raises(ValueError, match="below its modulus"):
        convert.public_key_from_numpy(bad, "cpu", prm, check=True)
    with pytest.raises(ValueError, match="expected"):
        convert.public_key_from_numpy(tr.pk.data[:, :k], "cpu", prm)
    with pytest.raises(ValueError, match="need params"):
        convert.public_key_from_numpy(tr.pk.data, "cpu", ct_limbs_only=True)
    bad_sk = tr.sk.s_ntt.copy()
    bad_sk[0, 0] = prm.key_moduli[0]
    with pytest.raises(ValueError, match="below its modulus"):
        convert.secret_key_from_numpy(bad_sk, "cpu", prm, check=True)
    with pytest.raises(ValueError, match="expected"):
        convert.secret_key_from_numpy(tr.sk.s_ntt[:k], "cpu", prm)
    bad_m = tr.plains.copy()
    bad_m[0, 3] = prm.t
    with pytest.raises(ValueError, match="plain modulus"):
        convert.plaintexts_from_numpy(bad_m, "cpu", prm, check=True)
    with pytest.raises(ValueError, match="expected"):
        convert.plaintexts_from_numpy(tr.plains[:, :8], "cpu", prm)
    for fn, arg in ((convert.public_key_from_numpy, tr.pk.data),
                    (convert.plaintexts_from_numpy, tr.plains),
                    (convert.from_numpy, tr.plains)):
        with pytest.raises(TypeError):
            fn(arg.astype(np.int64), "cpu")
    with pytest.raises(TypeError):
        convert.secret_key_from_numpy(tr.sk.s_ntt.astype(np.int64), "cpu",
                                      prm)

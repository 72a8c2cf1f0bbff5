"""The port's torch NTT against the JAX package's golden numpy NTT
(``fhe_precompiles_tpu.bfv.ntt``) on the moduli stacks the multiply path
uses.  Exact integer arithmetic: every comparison is ``np.array_equal``.
"""
import numpy as np
import pytest
import torch

from fhe_precompiles_tpu.bfv import ntt as jax_ntt
from fhe_precompiles_tpu.bfv.modmath import get_ntt_tables as jax_tables
from fhe_precompiles_tpu.bfv.modmath import mulmod as np_mulmod

from fhe_precompiles_tpu_torch.bfv import BfvContext
from fhe_precompiles_tpu_torch.ops import modmath as tm
from fhe_precompiles_tpu_torch.ops.ntt import build_tables, intt, ntt
from fhe_precompiles_tpu_torch.params import BENCH_N8192, TESTNET_ONE

# the suite runs several workers side by side: keep torch to one thread each
torch.set_num_threads(1)

G1 = BfvContext(TESTNET_ONE)
G8 = BfvContext(BENCH_N8192)
STACKS = {
    "one-q": (G1.q_mods, 4096),
    "one-q+bsk": (G1.q_mods + G1.Bsk, 4096),
    "one-key": (G1.key_mods, 4096),
    "n8192-q+bsk": (G8.q_mods + G8.Bsk, 8192),
}


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64))


def _np(x):
    return x.contiguous().numpy().view(np.uint64)


def _rand(rng, lead, mods, n):
    out = np.empty(lead + (len(mods), n), dtype=np.uint64)
    for li, p in enumerate(mods):
        out[..., li, :] = rng.integers(0, p, size=lead + (n,),
                                       dtype=np.uint64)
    # boundary residues
    for li, p in enumerate(mods):
        out[..., li, 0], out[..., li, 1] = p - 1, 0
    return out


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_forward_matches_golden_ntt(stack):
    mods, n = STACKS[stack]
    x = _rand(np.random.default_rng(11), (2, 2), mods, n)
    got = _np(ntt(_t(x), build_tables(mods, n, "cpu")))
    for li, p in enumerate(mods):
        want = jax_ntt.ntt(x[..., li, :], jax_tables(int(p), n))
        assert np.array_equal(got[..., li, :], want)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_inverse_matches_golden_intt_and_roundtrips(stack):
    mods, n = STACKS[stack]
    x = _rand(np.random.default_rng(12), (3,), mods, n)
    tb = build_tables(mods, n, "cpu")
    got = _np(intt(_t(x), tb))
    for li, p in enumerate(mods):
        want = jax_ntt.intt(x[..., li, :], jax_tables(int(p), n))
        assert np.array_equal(got[..., li, :], want)
    assert np.array_equal(_np(intt(ntt(_t(x), tb), tb)), x)
    assert np.array_equal(_np(ntt(intt(_t(x), tb), tb)), x)


@pytest.mark.parametrize("stack", ["one-q+bsk", "n8192-q+bsk"])
def test_inverse_with_folded_factors(stack):
    """n_inv_factors fold a per-limb constant into n^-1: the engine's
    t * q_hat_inv for the q limbs and t for the Bsk limbs."""
    mods, n = STACKS[stack]
    g = G1 if n == 4096 else G8
    t = g.t
    factors = ([t * g.q_hat_inv[i] % p for i, p in enumerate(g.q_mods)]
               + [t] * len(g.Bsk))
    x = _rand(np.random.default_rng(13), (2,), mods, n)
    got = _np(intt(_t(x), build_tables(mods, n, "cpu",
                                        n_inv_factors=factors)))
    for li, p in enumerate(mods):
        plain = jax_ntt.intt(x[..., li, :], jax_tables(int(p), n))
        want = np_mulmod(plain, np.uint64(factors[li]), p)
        assert np.array_equal(got[..., li, :], want)


def test_modmath_primitives_match_numpy_golden():
    from fhe_precompiles_tpu.bfv import modmath as nm
    rng = np.random.default_rng(14)
    for p in G1.key_mods + G1.Bsk:
        a = rng.integers(0, p, size=4096, dtype=np.uint64)
        b = rng.integers(0, p, size=4096, dtype=np.uint64)
        a[:3], b[:3] = [0, p - 1, p - 1], [0, p - 1, 1]
        ta, tb = _t(a), _t(b)
        assert np.array_equal(_np(tm.addmod(ta, tb, p)), nm.addmod(a, b, p))
        assert np.array_equal(_np(tm.submod(ta, tb, p)), nm.submod(a, b, p))
        assert np.array_equal(_np(tm.negmod(ta, p)), nm.negmod(a, p))
        assert np.array_equal(_np(tm.mulmod(ta, tb, p)), nm.mulmod(a, b, p))
        # lazy first factor (< 4p) stays exact
        lazy = a + np.uint64(3 * p)
        want = [(int(x) * int(y)) % p for x, y in zip(lazy[:64], b[:64])]
        assert _np(tm.mulmod(_t(lazy), tb, p))[:64].tolist() == want
        assert np.array_equal(_np(tm.csub_reduce(_t(lazy), p, 3)), a)


def test_shoup_and_barrett_constants_match_jax_package():
    from fhe_precompiles_tpu.ops import modmath as jm
    p = np.array(G1.key_mods, dtype=np.uint64).reshape(-1, 1)
    w = np.array([[1, 2, 12345678901], [p[0, 0] - 1, 7, 0],
                  [3, p[2, 0] - 1, 99]], dtype=np.uint64)
    w = w % p
    assert np.array_equal(tm.shoup_precompute(w, p), jm.shoup_precompute(w, p))
    assert np.array_equal(tm.barrett_mu(p), jm.barrett_mu(p))

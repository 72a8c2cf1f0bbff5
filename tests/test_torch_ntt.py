"""The port's NTT wrappers (on the CPU: the plain versions of the kernels)
against the JAX package's golden numpy NTT (``fhe_precompiles_tpu.bfv.ntt``)
on the moduli stacks the engine uses, and against the Pallas kernels they
replace (``PairPallasNtt`` in interpret mode); the Shoup companions of the
twiddle tables against Python integers.  Exact integer arithmetic: every
comparison is ``np.array_equal``.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from fhe_precompiles_tpu.bfv import ntt as jax_ntt
from fhe_precompiles_tpu.bfv.modmath import get_ntt_tables as jax_tables
from fhe_precompiles_tpu.bfv.modmath import mulmod as np_mulmod

from fhe_precompiles_tpu_torch.bfv import BfvContext
from fhe_precompiles_tpu_torch.ops import modmath as tm
from fhe_precompiles_tpu_torch.ops import ntt as tn
from fhe_precompiles_tpu_torch.ops.ntt import build_tables, intt, ntt
from fhe_precompiles_tpu_torch.params import (BENCH_N1024, BENCH_N8192,
                                              TESTNET_ONE)

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


# ----------------------------------------------------------------------
# against the Pallas kernels the CUDA kernels replace
# ----------------------------------------------------------------------
def _pallas(mods, n, **kw):
    from fhe_precompiles_tpu.ops.pallas_pair_ntt import PairPallasNtt
    return PairPallasNtt(mods, n, tb=2, interpret=True, **kw)


def _pair(x):
    from fhe_precompiles_tpu.ops import pair as pr
    return pr.split64(x)


def _unpair(xp):
    lo, hi = (np.asarray(v).astype(np.uint64) for v in xp)
    return lo | (hi << np.uint64(32))


def test_wrappers_match_pallas_pair_ntt_interpret():
    """n = 256 over q u Bsk, three ciphertext rows (not a multiple of the
    Pallas tile: its padding is its own affair)."""
    n, mods = 256, G1.q_mods + G1.Bsk
    x = _rand(np.random.default_rng(21), (3,), mods, n)
    tb = build_tables(mods, n, "cpu")
    pp = _pallas(mods, n)
    fwd = pp.ntt(_pair(x))
    assert np.array_equal(_np(ntt(_t(x), tb)), _unpair(fwd))
    assert np.array_equal(_np(intt(_t(_unpair(fwd)), tb)),
                          _unpair(pp.intt(fwd)))
    assert np.array_equal(_np(intt(_t(x), tb)), _unpair(pp.intt(_pair(x))))


def test_folded_inverse_matches_pallas_pair_ntt_interpret():
    n, mods, t = 256, G1.q_mods, TESTNET_ONE.t
    factors = [t * G1.q_hat_inv[i] % p for i, p in enumerate(mods)]
    x = _rand(np.random.default_rng(22), (2,), mods, n)
    got = _np(intt(_t(x), build_tables(mods, n, "cpu",
                                        n_inv_factors=factors)))
    want = _unpair(_pallas(mods, n, n_inv_factors=factors).intt(_pair(x)))
    assert np.array_equal(got, want)


# ----------------------------------------------------------------------
# the tables the kernels read
# ----------------------------------------------------------------------
PRESETS = {"testnet.one": TESTNET_ONE, "bench.n8192": BENCH_N8192,
           "bench.n1024": BENCH_N1024}


def _preset_moduli(name):
    """Every modulus the preset's engine transforms over: q, Bsk, key."""
    g = BfvContext(PRESETS[name])
    return g, sorted(set(g.q_mods + g.Bsk + g.key_mods))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_shoup_tables_equal_python_integers(name):
    """floor(w * 2**40 / p) for every twiddle of every limb the preset's
    engine transforms over, and for n^-1 with a factor folded in."""
    g, mods = _preset_moduli(name)
    factors = [(g.t * 7 + i) % p for i, p in enumerate(mods)]
    tb = build_tables(mods, g.n, "cpu", n_inv_factors=factors)
    jt = [jax_tables(int(p), g.n) for p in mods]
    for li, p in enumerate(mods):
        for words, shoup, ref in (
                (tb.root, tb.root_shoup40, jt[li].root_powers),
                (tb.inv_root, tb.inv_root_shoup40, jt[li].inv_root_powers)):
            w = _np(words[li]).tolist()
            assert w == [int(v) for v in ref]
            assert _np(shoup[li]).tolist() == [(v << 40) // p for v in w]
        n_inv = int(jt[li].n_inv) * factors[li] % p
        assert int(_np(tb.n_inv)[li, 0]) == n_inv
        assert int(_np(tb.n_inv_shoup40)[li, 0]) == (n_inv << 40) // p
        assert int(_np(tb.p)[li, 0]) == p


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_shoup40_tables_equal_jax_pair_shoup40(name):
    """The tables' 40-bit Shoup words against the JAX package's own
    ``pair.shoup40``, which its NTT kernel (``shoup_bits=40``) reads."""
    from fhe_precompiles_tpu.ops import pair as pr
    g, mods = _preset_moduli(name)
    tb = build_tables(mods, g.n, "cpu", n_inv_factors=[3] * len(mods))
    p_col = np.array(mods, dtype=np.uint64).reshape(-1, 1)
    for words, shoup in ((tb.root, tb.root_shoup40),
                         (tb.inv_root, tb.inv_root_shoup40),
                         (tb.n_inv, tb.n_inv_shoup40)):
        assert np.array_equal(_np(shoup), pr.shoup40(_np(words), p_col))
        assert np.array_equal(_np(shoup), tm.shoup40_precompute(_np(words),
                                                                p_col))
        assert int(_np(shoup).max()) < 1 << 40


@pytest.mark.parametrize("p", [1 << 37, (1 << 37) + 1, (1 << 61) - 1])
def test_build_tables_refuses_moduli_from_two_to_the_37(p):
    with pytest.raises(ValueError, match="below 2"):
        build_tables([G1.q_mods[0], p], 64, "cpu")


def _mul_shoup40_lazy(a: int, w: int, ws40: int, p: int) -> int:
    """csrc/modmath.cuh ``mul_shoup40_lazy`` step by step on the FP64 pipe's
    terms, each double held as the exact value it stands for (Python
    integers and ``float``, which rounds to nearest as the card's _rn steps
    do).  Each step asserts the condition that makes it exact on the card."""
    two52 = 1 << 52
    assert a < 1 << 39 and w < p < 1 << 37 and ws40 < 1 << 40
    # fma(a, ws40 * 2^-40, 2^52) rounded down: the doubles of [2^52, 2^53)
    # are the integers, so it is 2^52 + floor(a * ws40 / 2^40)
    q = (a * ws40 + (two52 << 40)) // (1 << 40) - two52
    assert 0 <= q < 1 << 40
    h = int(float(a) * float(w))                    # a*w rounded to nearest
    l = a * w - h                                   # fma(a, w, -h): exact
    assert abs(l) <= 1 << 22 and float(l) == l
    t = h - q * p                                   # fma(-q, p, h)
    assert abs(t) < 1 << 53 and float(t) == t
    r = t + l                                       # t + (l + 2^52) - 2^52
    assert 0 <= r < 1 << 52 and float(l + two52) == l + two52
    return r


def _shoup40_primes():
    out = set()
    for name in PRESETS:
        out.update(_preset_moduli(name)[1])
    return sorted(out)


def test_shoup40_lazy_product_exact_below_one_and_a_half_p():
    """The kernels' butterfly product for every prime of testnet.one (q,
    q u Bsk, key), bench.n8192 and bench.n1024 (a 27-bit prime: a1 = 0):
    a in {0, 1, p - 1, 2p, 4p - 1} and random a < 4p, w in {0, 1, p - 1} and
    random w < p.  The emulation's remainder is congruent to a*w, lies in
    [0, 1.5p), and equals the JAX package's ``pair.mulmod_shoup40`` (lazy),
    run eagerly on the CPU."""
    from fhe_precompiles_tpu.ops import pair as pr
    rng = np.random.default_rng(25)
    primes = _shoup40_primes()
    assert min(primes) < 1 << 32 and max(primes) > 1 << 36
    for p in primes:
        a = np.concatenate([np.array([0, 1, p - 1, 2 * p, 4 * p - 1],
                                     dtype=np.uint64),
                            rng.integers(0, 4 * p, 59, dtype=np.uint64)])
        w = np.concatenate([np.array([0, 1, p - 1], dtype=np.uint64),
                            rng.integers(0, p, 29, dtype=np.uint64)])
        a, w = (v.ravel() for v in np.meshgrid(a, w))
        ws = tm.shoup40_precompute(w, p)
        r = np.array([_mul_shoup40_lazy(int(x), int(y), int(s), p)
                      for x, y, s in zip(a, w, ws)], dtype=np.uint64)
        exact = (a.astype(object) * w.astype(object)) % p
        assert np.array_equal(r.astype(object) % p, exact)
        assert (2 * r.astype(object) < 3 * p).all()
        pv = np.full_like(a, p)
        ref = pr.mulmod_shoup40(pr.split64(a), pr.split64(w), pr.split64(ws),
                                pr.split64(pv), lazy=True)
        assert np.array_equal(r, _unpair(ref))


def test_shoup_lazy_product_is_exact_for_any_word():
    """The kernels' butterfly product, in Python integers: for every 64-bit
    a, a*w - hi64(a*ws)*p lies in [0, 2p) and is congruent to a*w, for a
    prime near 2^27 and one near 2^61 alike."""
    rng = np.random.default_rng(23)
    for p in (BENCH_N1024.coeff_modulus[0], TESTNET_ONE.coeff_modulus[2],
              (1 << 61) - 1):
        for _ in range(200):
            w = int(rng.integers(0, p))
            a = int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
            ws = (w << 64) // p
            r = (a * w - ((a * ws) >> 64) * p) % (1 << 64)
            assert 0 <= r < 2 * p and r % p == a * w % p


# ----------------------------------------------------------------------
# what the wrappers take and refuse
# ----------------------------------------------------------------------
def test_wrapper_on_cpu_takes_a_strided_view_and_launches_nothing():
    n, mods = 256, G1.q_mods
    tb = build_tables(mods, n, "cpu")
    ct = _t(_rand(np.random.default_rng(24), (3, 2), mods, n))
    tn.reset_launch_counts()
    view = ct[:, 1]
    assert not view.is_contiguous()
    assert torch.equal(ntt(view, tb), ntt(view.contiguous(), tb))
    assert torch.equal(intt(view, tb), tn.intt_plain(view.contiguous(), tb))
    assert tn.launch_counts == {"ntt": 0, "intt": 0}


def test_group_stride_of_views():
    """The stride the kernel is handed, computed on the host: contiguous
    stacks, the decrypt view ``ct[:, comp]``, and what is refused."""
    L, n = 2, 8
    x = torch.zeros((4, 3, L, n), dtype=torch.int64)
    assert tn._group_stride(x, "ntt", L, n) == L * n
    assert tn._group_stride(x[0, 0], "ntt", L, n) == L * n
    assert tn._group_stride(x[:, 1], "ntt", L, n) == 3 * L * n
    with pytest.raises(ValueError, match="contiguous"):
        tn._group_stride(torch.zeros((n, L), dtype=torch.int64).t(), "ntt",
                         L, n)
    with pytest.raises(ValueError, match="contiguous"):
        tn._group_stride(x[..., ::2], "ntt", L, n // 2)
    with pytest.raises(ValueError, match="collapse"):
        tn._group_stride(x[:, :2], "ntt", L, n)
    with pytest.raises(ValueError, match="16-byte"):
        tn._group_stride(torch.zeros(L * n + 1, dtype=torch.int64)[1:]
                         .view(L, n), "ntt", L, n)

"""Each plain tail segment of the PyTorch port against the JAX package's
``PairBehz`` segment, run eagerly on the CPU -- the same plain reference that
tests/test_pallas_tail.py holds the Pallas kernels to.

Inputs are uniform canonical residues per limb from a seeded numpy generator,
with hand-placed values that force both branches of the m_tilde and alpha
centring and the zero case of the negation.  Tolerance: none -- all
arithmetic is exact modular integer math, every comparison is
``np.array_equal`` on uint64.
"""
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

import fhe_precompiles_tpu.ops.behz_pair as bz
from fhe_precompiles_tpu.bfv import BfvContext as JaxBfvContext
from fhe_precompiles_tpu.ops import pair as pairm
from fhe_precompiles_tpu.ops.engine import JaxEngine
from fhe_precompiles_tpu.params import BENCH_N8192 as JAX_N8192
from fhe_precompiles_tpu.params import TESTNET_ONE as JAX_TESTNET_ONE

from fhe_precompiles_tpu_torch.bfv import BfvContext
from fhe_precompiles_tpu_torch.ops import tail, tail_cases
from fhe_precompiles_tpu_torch.params import (BENCH_N1024, BENCH_N8192,
                                              TESTNET_ONE)

# the suite runs several workers side by side: keep torch to one thread each
torch.set_num_threads(1)


def _rand_rows(rng, shape, mods, n):
    out = np.empty(shape + (n,), dtype=np.uint64)
    for idx in np.ndindex(shape[:-1]):
        for li, p in enumerate(mods):
            out[idx + (li,)] = rng.integers(0, p, size=n, dtype=np.uint64)
    return out


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64))


def _np(x):
    return x.contiguous().numpy().view(np.uint64)


def _pair(arr):
    return pairm.to_pair(jnp.asarray(arr))


def _unpair(p):
    return np.asarray(pairm.from_pair(p))


class Side:
    """One parameter set on both sides: the JAX pair kernels' plain (XLA)
    formulation and the port's constants."""

    def __init__(self, jax_params, params):
        self.g = BfvContext(params)
        self.c = tail.TailConstants(self.g, "cpu")
        eng = JaxEngine(jax_params, golden=JaxBfvContext(jax_params),
                        ntt_backend="pair", pair_tail="xla")
        self.pb = eng._pairk

    def jax_to_bsk_ext(self, a):
        ap = _pair(a)
        return np.concatenate([a, _unpair(self.pb.to_bsk(ap))], axis=-2)

    def jax_floor_sk(self, tq):
        pb, k = self.pb, self.pb.k
        tqp = _pair(tq)
        y = bz._ix(tqp, np.s_[..., :k, :])
        conv = pb._fastbconv(y, pb.q_hat_mod_bsk, pb.bsk, pb.mu_bsk32, k)
        num = pairm.submod(bz._ix(tqp, np.s_[..., k:, :]), conv, pb.bsk)
        floor_bsk = pairm.mulmod_shoup(num, *pb.inv_q_mod_bsk, pb.bsk)
        return _unpair(pb.fastbconv_sk(floor_bsk))


@pytest.fixture(scope="module")
def one():
    return Side(JAX_TESTNET_ONE, TESTNET_ONE)


@pytest.fixture(scope="module")
def n8192():
    return Side(JAX_N8192, BENCH_N8192)


def test_to_bsk_ext_matches_jax_segment(one):
    g = one.g
    rng = np.random.default_rng(101)
    a = _rand_rows(rng, (2, 2, g.k), g.q_mods, g.n)
    a[0] = tail_cases.place_r_cases(a[0], g)
    got = _np(tail.to_bsk_ext(_t(a), one.c))
    assert got.shape == (2, 2, one.c.nb, g.n)
    assert np.array_equal(got, one.jax_to_bsk_ext(a))


def test_to_bsk_ext_branch_cases_hit_both_sides(one):
    """The hand-placed positions really carry r on both sides of m_tilde/2,
    and the centred correction there is what the golden model computes."""
    g = one.g
    a = tail_cases.place_r_cases(
        np.zeros((1, g.k, g.n), dtype=np.uint64), g)
    got = _np(tail.to_bsk_ext(_t(a), one.c))
    targets = tail_cases.r_targets(g)
    assert min(targets) == 0 and max(targets) == g.m_tilde - 1
    assert g.m_tilde // 2 in targets and g.m_tilde // 2 + 1 in targets
    want = g._to_bsk(a[0])
    assert np.array_equal(got[0, g.k:], want)
    assert np.array_equal(got[0, :g.k], a[0])


def test_dyadic_matches_jax_segment(one):
    g, pb = one.g, one.pb
    mods = g.q_mods + g.Bsk
    rng = np.random.default_rng(102)
    fa = _rand_rows(rng, (2, 2, one.c.nb), mods, g.n)
    fb = _rand_rows(rng, (2, 2, one.c.nb), mods, g.n)
    # boundary residues: 0 and p - 1 on every limb
    for li, p in enumerate(mods):
        fa[0, :, li, 0], fb[0, :, li, 0] = p - 1, p - 1
        fa[0, :, li, 1], fb[0, :, li, 1] = 0, p - 1
    fap, fbp = _pair(fa), _pair(fb)
    tpa = pb.tp_all
    pa, mua, c64a = tpa.p, tpa.mu, tpa.c64
    fa0, fa1 = bz._ix(fap, np.s_[:, 0]), bz._ix(fap, np.s_[:, 1])
    fb0, fb1 = bz._ix(fbp, np.s_[:, 0]), bz._ix(fbp, np.s_[:, 1])
    t0 = pairm.mulmod(fa0, fb0, pa, mua, c64a)
    t2 = pairm.mulmod(fa1, fb1, pa, mua, c64a)
    cross = pairm.mulmod(pairm.addmod(fa0, fa1, pa), pairm.addmod(fb0, fb1, pa),
                      pa, mua, c64a)
    t1 = pairm.submod(pairm.submod(cross, t0, pa), t2, pa)
    want = _unpair(bz._stack([t0, t1, t2], axis=1))
    got = _np(tail.dyadic(_t(fa), _t(fb), one.c))
    assert np.array_equal(got, want)


def test_floor_sk_matches_jax_segment(one):
    g = one.g
    rng = np.random.default_rng(103)
    tq = _rand_rows(rng, (2, 3, one.c.nb), g.q_mods + g.Bsk, g.n)
    tq[0] = tail_cases.place_alpha_cases(tq[0], g)
    got = _np(tail.floor_sk(_t(tq), one.c))
    assert got.shape == (2, 3, g.k, g.n)
    assert np.array_equal(got, one.jax_floor_sk(tq))


def test_floor_sk_branch_cases_include_zero_negation(one):
    """alpha on both sides of m_sk/2, and alpha = m_sk - q_i, whose reduced
    negation must be 0 and not q_i; held to the golden model."""
    g = one.g
    targets = tail_cases.alpha_targets(g)
    assert g.m_sk // 2 in targets and g.m_sk // 2 + 1 in targets
    assert any(g.m_sk - a in g.q_mods for a in targets)
    tq = tail_cases.place_alpha_cases(
        np.zeros((1, one.c.nb, g.n), dtype=np.uint64), g)
    got = _np(tail.floor_sk(_t(tq), one.c))
    # golden path on the same scaled tensor: conv = 0 at these positions
    fl = np.stack([
        (tq[0, g.k + xi].astype(object) * g.inv_q_mod_x[x] % x
         ).astype(np.uint64) for xi, x in enumerate(g.Bsk)])
    assert np.array_equal(got[0], g._fastbconv_sk(fl))


def test_relin_dot_matches_jax_segment(one):
    g, pb = one.g, one.pb
    k, k_key = g.k, g.k_key
    rng = np.random.default_rng(104)
    d = _rand_rows(rng, (2, k, k_key), g.key_mods, g.n)
    rk = _rand_rows(rng, (k, 2, k_key), g.key_mods, g.n)
    for li, p in enumerate(g.key_mods):       # largest products
        d[0, :, li, 0] = p - 1
        rk[:, :, li, 0] = p - 1
    dp, rkp = _pair(d), _pair(rk)
    tpk = pb.tp_key
    accs = []
    for comp in range(2):
        acc = pairm.mulmod(bz._ix(dp, np.s_[:, 0]), bz._ix(rkp, np.s_[0, comp]),
                        tpk.p, tpk.mu, tpk.c64, lazy=True)
        for j in range(1, k):
            acc = pairm.add_pair(acc, pairm.mulmod(
                bz._ix(dp, np.s_[:, j]), bz._ix(rkp, np.s_[j, comp]),
                tpk.p, tpk.mu, tpk.c64, lazy=True))
        accs.append(pairm.barrett(acc, tpk.mu, tpk.p, x_max_bits=44))
    want = _unpair(bz._stack(accs, axis=1))
    got = _np(tail.relin_dot(_t(d), _t(rk), one.c))
    assert np.array_equal(got, want)


def test_mod_down_matches_jax_segment(one):
    g, pb = one.g, one.pb
    k, k_key = g.k, g.k_key
    rng = np.random.default_rng(105)
    acc = _rand_rows(rng, (2, 2, k_key), g.key_mods, g.n)
    ct3 = _rand_rows(rng, (2, 3, k), g.q_mods, g.n)
    P = g.P
    acc[0, :, k_key - 1, :4] = [0, P - 1, P // 2, P // 2 + 1]  # rounding edge
    accp, ctp = _pair(acc), _pair(ct3[:, :2])
    xP = bz._ix(accp, np.s_[..., k_key - 1, :])
    P_scalar = (pb.P[0][0, 0], pb.P[1][0, 0])
    xP_half = pairm.addmod(xP, (pb.P_half[0][0, 0], pb.P_half[1][0, 0]),
                        P_scalar)
    corr = pairm.submod(
        pairm.csub_reduce(bz._ix(xP_half, np.s_[..., None, :]), pb.q_mods,
                       pb.steps_P_mod_q),
        pb.half_mod_q, pb.q_mods)
    ti = pairm.submod(bz._ix(accp, np.s_[..., :k, :]), corr, pb.q_mods)
    res = pairm.mulmod_shoup(ti, *pb.inv_P_mod_q, pb.q_mods)
    want = _unpair(pairm.addmod(ctp, res, pb.q_mods))
    # the pipeline passes the strided view ct3[:, :2]
    got = _np(tail.mod_down(_t(acc), _t(ct3)[:, :2], one.c))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("segment", ["to_bsk_ext", "floor_sk"])
def test_n8192_preset_matches_jax_segment(n8192, segment):
    """Other limb counts (k = 3, five Bsk limbs) reach every limb loop."""
    g = n8192.g
    rng = np.random.default_rng(106)
    if segment == "to_bsk_ext":
        a = _rand_rows(rng, (1, 2, g.k), g.q_mods, g.n)
        a[0] = tail_cases.place_r_cases(a[0], g)
        got = _np(tail.to_bsk_ext(_t(a), n8192.c))
        assert np.array_equal(got, n8192.jax_to_bsk_ext(a))
    else:
        tq = _rand_rows(rng, (1, 3, n8192.c.nb), g.q_mods + g.Bsk, g.n)
        tq[0] = tail_cases.place_alpha_cases(tq[0], g)
        got = _np(tail.floor_sk(_t(tq), n8192.c))
        assert np.array_equal(got, n8192.jax_floor_sk(tq))


def test_struct_refuses_a_preset_that_does_not_fit(one, monkeypatch):
    c = tail.TailConstants(one.g, "cpu")
    monkeypatch.setattr(tail, "MAX_K", 1)
    with pytest.raises(ValueError, match="does not fit"):
        c.struct


def test_struct_holds_exact_shoup_and_barrett_constants(one):
    g, s = one.g, one.c.struct
    assert (s.k, s.nbsk, s.k_key) == (g.k, len(g.Bsk), g.k_key)
    for i, p in enumerate(g.q_mods):
        assert s.q[i] == p and s.q_mu[i] == (1 << 64) // p
        w = g.mtilde_mod_q[i] * g.q_hat_inv[i] % p
        assert s.mt_qhinv[i] == w and s.mt_qhinv_s[i] == (w << 64) // p
        assert s.inv_P_q_s[i] == (g.inv_P_mod_q[i] << 64) // p
    for j, x in enumerate(g.Bsk):
        for i in range(g.k):
            w = g.q_hat[i] % x
            assert s.qhat_bsk[j][i] == w
            assert s.qhat_bsk_s[j][i] == (w << 64) // x
    assert s.P == g.P and s.P_half == g.P >> 1

    # floor_sk's folded factors and their beta = 40 words, from the
    # definitions with Python integers (inverses by pow, not the context's)
    def holds(f, w, p):
        assert f.w == w and int(f.w) < p
        assert f.ws * 2 ** 40 == (w << 40) // p          # exact double
    q, B, msk = math.prod(g.q_mods), math.prod(g.B), g.m_sk
    k, nB = g.k, len(g.B)
    q_hat = [q // p for p in g.q_mods]
    ipb = pow(B, -1, msk)
    assert s.steps_msk_mod_q == max((msk - 1) // p for p in g.q_mods)
    assert s.msk_half_p1 == msk // 2 + 1
    assert [s.q_d[i] for i in range(k)] == g.q_mods
    assert [s.bsk_d[j] for j in range(nB + 1)] == g.Bsk
    for j, b in enumerate(g.B):
        c = pow(q, -1, b) * pow(B // b, -1, b) % b
        holds(s.fs_y2[j][k], c, b)
        for i in range(k):
            holds(s.fs_y2[j][i], -q_hat[i] * c % b, b)
        holds(s.fs_alpha[j], (B // b) * ipb % msk, msk)
    holds(s.fs_alpha[nB], -pow(q, -1, msk) * ipb % msk, msk)
    for i in range(k):
        holds(s.fs_alpha[nB + 1 + i], q_hat[i] * pow(q, -1, msk) * ipb % msk,
              msk)
    for i, p in enumerate(g.q_mods):
        for j, b in enumerate(g.B):
            holds(s.fs_out[i][j], (B // b) % p, p)
        holds(s.fs_corr[i][0], -B % p, p)
        holds(s.fs_corr[i][1], B % p, p)


# ----------------------------------------------------------------------
# csrc/tail.cu floor_sk_at, step by step on exact integers
# ----------------------------------------------------------------------
def _term(a: int, f, p: int) -> int:
    """csrc/modmath.cuh ``shoup40_d``: a * w - q * p with the beta = 40
    quotient, each FP64 step held as the exact value it stands for (Python
    ``float`` rounds to nearest as the card's _rn steps do).  Asserts the
    kernel's input bound and each step's exactness condition."""
    w, ws40 = int(f.w), int(f.ws * 2 ** 40)
    assert 0 <= a < 1 << 39 and w < p < 1 << 37 and ws40 < 1 << 40
    q = a * ws40 >> 40              # fma(a, ws, 2^52) rounded down, - 2^52
    h = int(float(a) * float(w))    # a*w rounded to nearest
    l = a * w - h                   # fma(a, w, -h): exact
    t = h - q * p                   # fma(-q, p, h): exact
    assert float(l) == l and abs(t) < 1 << 53 and float(t) == t
    r = t + l                       # the integer term, exact below 2^52
    assert (r - a * w) % p == 0
    assert 0 <= r and r << 40 < p * ((1 << 40) + a)     # r < p (1 + a/2^40)
    return r


def _dsum(terms) -> int:
    acc = 0
    for r in terms:                 # __dadd_rn of integers below 2^53
        acc += r
        assert acc < 1 << 53
    return acc


def _canonical(x: int, terms: int, p: int) -> int:
    """``canonical<terms>``: x < 9 * terms / 8 * p (the comment's bound),
    then conditional subtracts of 2^e p, e from m - 1 down to 0."""
    assert 8 * x < 9 * terms * p
    m = 0
    while (8 << m) < 9 * terms:
        m += 1
    for e in reversed(range(m)):
        if x >= p << e:
            x -= p << e
    assert 0 <= x < p
    return x


def _emulate_floor_sk_at(y, x, s, k: int, nbsk: int):
    nB = nbsk - 1
    y2 = []
    for j in range(nB):
        p = int(s.bsk_d[j])
        total = _dsum([_term(x[j], s.fs_y2[j][k], p)]
                      + [_term(y[i], s.fs_y2[j][i], p) for i in range(k)])
        y2.append(_canonical(total, k + 1, p))
    msk = int(s.bsk_d[nB])
    total = _dsum([_term(x[nB], s.fs_alpha[nB], msk)]
                  + [_term(y2[j], s.fs_alpha[j], msk) for j in range(nB)]
                  + [_term(y[i], s.fs_alpha[nB + 1 + i], msk)
                     for i in range(k)])
    alpha = _canonical(total, nB + 1 + k, msk)    # canonical before centring
    big = alpha >= s.msk_half_p1
    mag = msk - alpha if big else alpha
    assert mag <= msk // 2
    out = []
    for i in range(k):
        p = int(s.q_d[i])
        if s.steps_msk_mod_q <= tail.MSK_CSUB_STEPS:
            assert mag < (s.steps_msk_mod_q + 1) * p
            red = mag
            for _ in range(s.steps_msk_mod_q):
                red = red - p if red >= p else red
        else:                                     # one Barrett step: exact
            red = mag % p
        assert red < p
        total = _dsum([_term(red, s.fs_corr[i][int(big)], p)]
                      + [_term(y2[j], s.fs_out[i][j], p) for j in range(nB)])
        out.append(_canonical(total, nB + 1, p))
    return out


@pytest.mark.parametrize("params", [TESTNET_ONE, BENCH_N8192, BENCH_N1024],
                         ids=["testnet.one", "bench.n8192", "bench.n1024"])
def test_floor_sk_kernel_steps_emulated_match_plain(params):
    """The CUDA floor_sk's arithmetic, position by position with Python
    integers from the kernel's own struct, asserting every bound its comments
    state, against ``floor_sk_plain``: k = 2, 3, 1 and the csub and Barrett
    branches of alpha mod q_i.  Rows: two random, every residue p - 1, all
    zeros, and the hand-placed alpha cases; n = 64."""
    g = BfvContext(params)
    c = tail.TailConstants(g, "cpu")
    s, k, nbsk = c.struct, c.k, c.nbsk
    mods = g.q_mods + g.Bsk
    n = 64
    tq = _rand_rows(np.random.default_rng(107), (5, c.nb), mods, n)
    tq[2] = np.array(mods, dtype=np.uint64)[:, None] - np.uint64(1)
    tq[3] = 0
    tq[4:] = tail_cases.place_alpha_cases(tq[4:], g)
    want = _np(tail.floor_sk(_t(tq), c))
    got = np.zeros_like(want)
    for row in range(tq.shape[0]):
        for pos in range(n):
            col = [int(v) for v in tq[row, :, pos]]
            got[row, :, pos] = _emulate_floor_sk_at(col[:k], col[k:], s, k,
                                                    nbsk)
    assert np.array_equal(got, want)

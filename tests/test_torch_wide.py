"""The port's exact CRT scale-and-round (``ops/wide.py``, int64 lanes) against
the JAX package's (``fhe_precompiles_tpu.ops.wide``, uint64 lanes) and against
Python-integer rounding, on rounding-boundary and random inputs.  Exact:
``np.array_equal`` throughout.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from fhe_precompiles_tpu.ops.wide import ExactScaleRound as JaxExactScaleRound

from fhe_precompiles_tpu_torch.bfv import BfvContext
from fhe_precompiles_tpu_torch.ops import wide
from fhe_precompiles_tpu_torch.ops.wide import ExactScaleRound
from fhe_precompiles_tpu_torch.params import (BENCH_N1024, BENCH_N8192,
                                              TESTNET_ONE)

torch.set_num_threads(1)

PRESETS = {"testnet_one": TESTNET_ONE, "n8192_k3": BENCH_N8192,
           "n1024_k1": BENCH_N1024}
# a dot that the approximate t-gamma rounding got wrong on testnet.one
KNOWN_BOUNDARY_DOT = 6341038794891017812


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64))


def _np(x):
    return x.contiguous().numpy().view(np.uint64)


def _xs(q, t, rng, count):
    """CRT values x in [0, q): random ones, and the ones on and beside every
    rounding boundary of t*x/q for small and large m."""
    xs = [int(v) % q for v in rng.integers(0, 2**62, size=64)]
    xs += [int.from_bytes(rng.bytes(16), "little") % q for _ in range(64)]
    for m in (0, 1, 2, t // 2, t - 2, t - 1, t):
        base = m * q - q // 2
        for d in (-2, -1, 0, 1, 2):
            x = (base + d) // t
            if 0 <= x < q:
                xs.append(x)
                xs.append((base + d + t - 1) // t % q)
    xs += [0, 1, q - 1, q // 2, KNOWN_BOUNDARY_DOT % q]
    return (xs * (count // len(xs) + 1))[:count]


def _y_of(xs, g):
    """y_j = |x * q_hat_inv_j|_{q_j}: what decrypt hands the rounding."""
    y = np.zeros((1, g.k, len(xs)), dtype=np.uint64)
    for j, p in enumerate(g.q_mods):
        y[0, j] = [x % p * g.q_hat_inv[j] % p for x in xs]
    return y


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_exact_round_matches_jax_and_python_ints(name):
    prm = PRESETS[name]
    g = BfvContext(prm)
    q, t = prm.q, prm.t
    xs = _xs(q, t, np.random.default_rng(42), 256)
    y = _y_of(xs, g)
    got = _np(ExactScaleRound(g.q_mods, t)(_t(y)))[0]
    want = [(t * x + q // 2) // q % t for x in xs]
    assert got.tolist() == want
    jax_out = np.asarray(JaxExactScaleRound(g.q_mods, t)(y), dtype=np.uint64)
    assert np.array_equal(got, jax_out[0])
    # and the host model's own rounding of the same dots
    dot = np.array([[x % p for x in xs] for p in g.q_mods], dtype=np.uint64)
    assert np.array_equal(got, g._message_from_dot(dot))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_constants_equal_jax_package(name):
    prm = PRESETS[name]
    g = BfvContext(prm)
    a, b = ExactScaleRound(g.q_mods, prm.t), JaxExactScaleRound(g.q_mods,
                                                                 prm.t)
    for field in ("k", "t", "WS", "WZ", "WP", "sl", "n_csub", "q_hat_limbs",
                  "q_limbs_S", "t_limbs", "h_limbs", "q_limbs_Z", "mu_limbs"):
        assert getattr(a, field) == getattr(b, field), field


def test_limb_product_past_two_to_the_63():
    """int64 lanes: a product of two 32-bit limbs that are both >= 2**31 is
    negative as int64, and an arithmetic shift would smear its sign over the
    high limb.  Both halves must come out as the unsigned product's."""
    xa = np.array([0xFFFFFFFF, 0x80000000, 0xDEADBEEF, 0x80000001, 5],
                  dtype=np.uint64)
    for cb in (0xFFFFFFFF, 0x80000000, 0xC0000001):
        slots = [None, None, None]
        wide._mul_acc_const(slots, [_t(xa)], [cb],
                            torch.zeros(5, dtype=torch.int64))
        lo, hi, top = (_np(s).tolist() for s in slots)
        for i, v in enumerate(xa.tolist()):
            assert (lo[i], hi[i]) == (v * cb & 0xFFFFFFFF, v * cb >> 32)
        assert top == [0] * 5
    # without the mask after the shift the high limb is wrong: the case bites
    p = _t(xa) * 0xFFFFFFFF
    assert (_np(p >> 32) != _np((p >> 32) & 0xFFFFFFFF)).any()


def test_high_limb_case_through_the_whole_rounding():
    """A modulus stack whose q_hat limbs are >= 2**31, with residues whose
    limbs are too: the rounding still equals Python integers."""
    mods = [0xFFFFEE001, 0xFFFFC4001]         # testnet.one's q, 36 bits each
    q, t = mods[0] * mods[1], 4096
    esr = ExactScaleRound(mods, t)
    assert any(limb >= 1 << 31 for limbs in esr.q_hat_limbs for limb in limbs)
    rng = np.random.default_rng(7)
    y = np.empty((1, 2, 512), dtype=np.uint64)
    for j, p in enumerate(mods):
        # low limb forced into [2**31, 2**32)
        v = rng.integers(0, p, size=512, dtype=np.uint64)
        y[0, j] = np.minimum(v | np.uint64(0x80000000), np.uint64(p - 1))
    q_hat = [q // p for p in mods]
    want = []
    for i in range(512):
        x = sum(int(y[0, j, i]) * q_hat[j] for j in range(2)) % q
        want.append((t * x + q // 2) // q % t)
    assert _np(esr(_t(y)))[0].tolist() == want


def test_carry_and_borrow_helpers():
    a = [_t(np.array([0xFFFFFFFF + 5, 3], dtype=np.uint64)),
         _t(np.array([1, 0xFFFFFFFF], dtype=np.uint64))]
    lo, hi = wide._carry(a)
    assert _np(lo).tolist() == [4, 3] and _np(hi).tolist() == [2, 0xFFFFFFFF]
    x = [_t(np.array([0, 7], dtype=np.uint64)),
         _t(np.array([1, 0], dtype=np.uint64))]
    diff, geq = wide._sub_borrow(x, [1, 0])
    assert _np(diff[0]).tolist() == [0xFFFFFFFF, 6]
    assert _np(diff[1]).tolist() == [0, 0] and geq.tolist() == [True, True]
    _, geq = wide._sub_borrow(x, [8, 0])
    assert geq.tolist() == [True, False]
    assert wide._int_limbs((1 << 40) + 3, 2) == [3, 256]


def test_batched_leading_axes_and_dtype():
    g = BfvContext(TESTNET_ONE)
    rng = np.random.default_rng(3)
    y = np.stack([np.stack([rng.integers(0, p, size=(3, 64), dtype=np.uint64)
                            for p in g.q_mods], axis=1) for _ in range(2)])
    assert y.shape == (2, 3, 2, 64)
    esr = ExactScaleRound(g.q_mods, TESTNET_ONE.t)
    out = esr(_t(y))
    assert out.dtype == torch.int64 and tuple(out.shape) == (2, 3, 64)
    assert torch.equal(out[1, 2], esr(_t(y[1, 2])))
    assert int(out.min()) >= 0 and int(out.max()) < TESTNET_ONE.t

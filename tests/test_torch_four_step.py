"""The port's four-step NTT (``ops/four_step.py``; on the CPU the plain
versions of its kernels) against the JAX package's ``ops/mxu_ntt.py`` and
``PallasNtt`` in interpret mode, against the port's butterfly NTT, and
``TorchEngine(ntt_backend="four_step")`` against the JAX package's golden
model.  Exact integer arithmetic: every comparison is ``np.array_equal`` or
``torch.equal``.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from fhe_precompiles_tpu.bfv import BfvContext as JaxBfvContext
from fhe_precompiles_tpu.bfv import Ciphertext as JaxCiphertext
from fhe_precompiles_tpu.ops import mxu_ntt
from fhe_precompiles_tpu.params import TESTNET_ONE as JAX_TESTNET_ONE

from fhe_precompiles_tpu_torch import convert
from fhe_precompiles_tpu_torch.bfv import (BfvContext, Ciphertext, PublicKey,
                                           SecretKey)
from fhe_precompiles_tpu_torch.ops import four_step as fs
from fhe_precompiles_tpu_torch.ops import ntt as tn
from fhe_precompiles_tpu_torch.ops import tail
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine, check_card_limits
from fhe_precompiles_tpu_torch.params import (BENCH_N8192, TESTNET_ONE,
                                              Params, ntt_friendly_primes)

# the suite runs several workers side by side: keep torch to one thread each
torch.set_num_threads(1)

G1 = BfvContext(TESTNET_ONE)
ALL = tuple(G1.q_mods + G1.Bsk)
MODS = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)     # tests/test_pallas_ntt.py


def _t(arr):
    return torch.from_numpy(np.array(arr, dtype=np.uint64).view(np.int64))


def _np(x):
    return x.contiguous().numpy().view(np.uint64)


def _rand(rng, lead, mods, n):
    out = np.empty(lead + (len(mods), n), dtype=np.uint64)
    for li, p in enumerate(mods):
        out[..., li, :] = rng.integers(0, p, size=lead + (n,),
                                       dtype=np.uint64)
        out[..., li, 0], out[..., li, 1] = p - 1, 0
    return out


@pytest.fixture(scope="module")
def one_all():
    """q u Bsk of testnet.one at n = 4096, C = 64: the port's tables and the
    JAX package's."""
    return (fs.build_mxu_tables(ALL, 4096, "cpu"),
            mxu_ntt.build_mxu_tables(ALL, 4096))


# ----------------------------------------------------------------------
# tables
# ----------------------------------------------------------------------
def _equal_tables(port, ref):
    assert (port.n, port.R, port.C, port.diag_left) == (
        ref.n, ref.R, ref.C, ref.diag_left)
    for name in ("p", "mu", "T", "T_shoup", "Ti", "Ti_shoup", "pow_dig",
                 "pow_dig_shoup"):
        assert np.array_equal(_np(getattr(port, name)),
                              np.asarray(getattr(ref, name))), name
    for name in ("A_dig", "B0T_dig", "Ai_dig", "B0iT_dig"):
        got = getattr(port, name)
        assert got.dtype == torch.uint8, name
        want = np.asarray(getattr(ref, name)).astype(np.float32)
        assert np.array_equal(got.numpy().astype(np.float32), want), name
    # the kernels' layouts hold the same numbers
    R, C = port.R, port.C
    assert torch.equal(fs.unpack_wgmma(port.A_wg, R), port.A_dig)
    assert torch.equal(fs.unpack_wgmma(port.Ai_wg, R), port.Ai_dig)
    assert torch.equal(fs.unpack_wgmma(port.B0_wg, C),
                       port.B0T_dig.transpose(-1, -2))
    assert torch.equal(fs.unpack_wgmma(port.B0i_wg, C),
                       port.B0iT_dig.transpose(-1, -2))
    assert torch.equal(port.TT, port.T.transpose(-1, -2))
    assert torch.equal(port.TiT, port.Ti.transpose(-1, -2))


def test_tables_equal_jax_package_q_bsk_4096(one_all):
    _equal_tables(*one_all)


def test_tables_equal_jax_package_non_square_512():
    """n = 512, C = 16: R = 32, so the two matrices differ in size."""
    _equal_tables(fs.build_mxu_tables(MODS, 512, "cpu", C=16),
                  mxu_ntt.build_mxu_tables(MODS, 512, 16))


# ----------------------------------------------------------------------
# the plain transform against the JAX package and against the port
# ----------------------------------------------------------------------
def test_plain_equals_jitted_mxu_ntt(one_all):
    tb, ref = one_all
    x = _rand(np.random.default_rng(31), (2,), ALL, 4096)
    y = fs.ntt_plain(_t(x), tb)
    want = jax.jit(lambda v: mxu_ntt.ntt(v, ref))(jnp.asarray(x))
    assert np.array_equal(_np(y), np.asarray(want, dtype=np.uint64))
    back = jax.jit(lambda v: mxu_ntt.intt(v, ref))(jnp.asarray(_np(y)))
    assert np.array_equal(_np(fs.intt_plain(y, tb)),
                          np.asarray(back, dtype=np.uint64))


@pytest.mark.parametrize("fused", [True, False])
def test_equals_pallas_ntt_interpret(fused):
    """The kernels' form on the CPU against the Pallas kernels they replace,
    run as tests/test_pallas_ntt.py runs them: the forward transform in one
    launch (``_fused_call``), the inverse in two (``_phase`` "post", a
    transpose, ``_phase`` "none").  One direction each: an interpreted
    Pallas transform costs some 3 s."""
    from fhe_precompiles_tpu.ops.pallas_ntt import PallasNtt
    x = _rand(np.random.default_rng(32), (4,), MODS, 256)
    pn = PallasNtt(MODS, 256, C=16, tb=4, interpret=True, fused=fused)
    port = fs.FourStepNtt(MODS, 256, "cpu", C=16, fused=fused)
    if fused:
        got, want = port.ntt(_t(x)), pn.ntt(jnp.asarray(x))
    else:
        got, want = port.intt(_t(x)), pn.intt(jnp.asarray(x))
    assert np.array_equal(_np(got), np.asarray(want, dtype=np.uint64))


def test_plain_equals_butterfly_and_roundtrips(one_all):
    tb = one_all[0]
    btb = tn.build_tables(ALL, 4096, "cpu")
    x = _t(_rand(np.random.default_rng(33), (3,), ALL, 4096))
    y = fs.ntt_plain(x, tb)
    assert torch.equal(y, tn.ntt_plain(x, btb))
    assert torch.equal(fs.intt_plain(x, tb), tn.intt_plain(x, btb))
    assert torch.equal(fs.intt_plain(y, tb), x)


@pytest.mark.parametrize("fused", [True, False])
def test_folded_inverse_equals_butterfly_fold(fused):
    """n_inv_factors multiply A' before its digit split: the engine's
    t * q_hat_inv for the q limbs and t for the Bsk limbs, at n = 1024."""
    t = TESTNET_ONE.t
    factors = ([t * G1.q_hat_inv[i] % p for i, p in enumerate(G1.q_mods)]
               + [t] * len(G1.Bsk))
    x = _t(_rand(np.random.default_rng(34), (2,), ALL, 1024))
    got = fs.FourStepNtt(ALL, 1024, "cpu", fused=fused,
                         n_inv_factors=factors).intt(x)
    want = tn.intt_plain(x, tn.build_tables(ALL, 1024, "cpu",
                                            n_inv_factors=factors))
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", fs.PHASE_MODES)
def test_phase_equals_python_integers(mode):
    """One product W @ X mod p over 16 x 32 matrices, the grid before, after
    or not at all, against Python integers.  The weights go in packed as the
    kernel takes them, the grid as its words."""
    tb = fs.build_mxu_tables(MODS, 512, "cpu", C=16)       # R = 32
    rng = np.random.default_rng(35)
    K, J = 16, 32
    x = _rand(rng, (2,), MODS, K * J).reshape(2, len(MODS), K, J)
    w = _rand(rng, (), MODS, K * K).reshape(len(MODS), K, K)
    g = _rand(rng, (), MODS, K * J).reshape(len(MODS), K, J)
    packed = torch.from_numpy(
        fs.pack_wgmma(np.stack([fs._digits(m) for m in w])))
    grid = None if mode == "none" else _t(g)
    got = _np(fs.phase(_t(x), packed, grid, mode, tb))
    for li, p in enumerate(MODS):
        wl = w[li].astype(object)
        gl = g[li].astype(object)
        for b in range(2):
            xl = x[b, li].astype(object)
            if mode == "pre":
                xl = xl * gl % p
            want = wl.dot(xl) % p
            if mode == "post":
                want = want * gl % p
            assert np.array_equal(got[b, li], want.astype(np.uint64))


def test_two_launch_form_takes_the_strided_view():
    """decrypt hands over ``ct[:, comp]``: the not-fused form views it as
    matrices without a copy of its own, the fused form takes it as it is."""
    tb_q = fs.FourStepNtt(G1.q_mods, 1024, "cpu", fused=False)
    ct = _t(_rand(np.random.default_rng(36), (3, 2), G1.q_mods, 1024))
    view = ct[:, 1]
    assert not view.is_contiguous()
    want = fs.ntt_plain(view.contiguous(), tb_q.tables)
    assert torch.equal(tb_q.ntt(view), want)
    assert torch.equal(fs.ntt(view, tb_q.tables), want)


# ----------------------------------------------------------------------
# the engine's four-step configuration
# ----------------------------------------------------------------------
class FourStepCase:
    """testnet.one, B = 2: keys, plaintexts and ciphertexts from the JAX
    package's golden model, the port's engine on the CPU with the four-step
    transforms."""

    def __init__(self):
        self.g = JaxBfvContext(JAX_TESTNET_ONE)
        self.pk, self.sk = self.g.generate_keys(seed=b"\x61" * 64)
        rng = np.random.default_rng(0x61)
        self.plains = np.zeros((4, self.g.n), dtype=np.uint64)
        self.plains[:, :6] = rng.integers(0, 12, size=(4, 6), dtype=np.uint64)
        self.seeds = [bytes([i + 1]) * 64 for i in range(4)]
        self.cts = [self.g.encrypt(m, self.pk, s)
                    for m, s in zip(self.plains, self.seeds)]
        self.eng = TorchEngine(TESTNET_ONE, device="cpu",
                               ntt_backend="four_step")
        self.tpk = PublicKey(TESTNET_ONE, self.pk.data)
        self.tsk = SecretKey(TESTNET_ONE, self.sk.s_ntt)
        self.rk = convert.relin_keys_from_numpy(self.pk.relin.data, "cpu",
                                                TESTNET_ONE)


@pytest.fixture(scope="module")
def four():
    return FourStepCase()


def test_engine_holds_four_step_transforms(four):
    e = four.eng
    assert e.ntt_backend == "four_step"
    assert all(isinstance(v, fs.FourStepNtt) for v in e.ntts.values())
    assert e.behz.ntt_all == e._ntt_all and e.behz.intt_key == e._intt_key


def test_engine_mul_relin_equals_golden(four):
    a = convert.ciphertexts_from_numpy([c.data for c in four.cts[:2]], "cpu")
    b = convert.ciphertexts_from_numpy([c.data for c in four.cts[2:]], "cpu")
    tail.reset_launch_counts()
    fs.reset_launch_counts()
    out = convert.to_numpy(four.eng._mul_relin(a, b, four.rk))
    for i in range(2):
        want = four.g.mul_relin(four.cts[i], four.cts[2 + i], four.pk.relin)
        assert np.array_equal(out[i], want.data)
    assert not any(fs.launch_counts.values())
    assert not any(tail.launch_counts.values())


def test_engine_encrypt_decrypt_mul_plain_equal_golden(four):
    e = four.eng
    enc = e.encrypt_batch(four.plains[:2], four.tpk, four.seeds[:2])
    for i in range(2):
        assert np.array_equal(convert.to_numpy(enc)[i], four.cts[i].data)
    ct3 = e._multiply(enc, torch.roll(enc, 1, dims=0))
    for size, data in ((2, enc), (3, ct3)):
        got = convert.to_numpy(e.decrypt_batch(data, four.tsk))
        for i in range(2):
            host = JaxCiphertext(JAX_TESTNET_ONE, convert.to_numpy(data)[i])
            assert np.array_equal(got[i], four.g.decrypt(host, four.sk)), size
    assert np.array_equal(convert.to_numpy(e.decrypt_batch(enc, four.tsk)),
                          four.plains[:2])
    x = Ciphertext(TESTNET_ONE, four.cts[0].data)
    assert np.array_equal(e.mul_plain(x, four.plains[3]).data,
                          four.g.mul_plain(four.cts[0], four.plains[3]).data)


# ----------------------------------------------------------------------
# what is refused
# ----------------------------------------------------------------------
def test_unknown_ntt_backend_raises():
    for name in ("pallas", "stage", "four-step", ""):
        with pytest.raises(ValueError, match="unknown ntt_backend"):
            TorchEngine(TESTNET_ONE, device="cpu", ntt_backend=name)


def test_wrappers_do_not_fall_back_off_the_cpu():
    tb = fs.build_mxu_tables(MODS, 256, "cpu", C=16)

    def meta(*shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device="meta")

    fs.reset_launch_counts()
    for call in (lambda: fs.ntt(meta(1, 3, 256), tb),
                 lambda: fs.intt(meta(2, 3, 256), tb),
                 lambda: fs.phase(meta(1, 3, 16, 16), tb.A_wg, None, "none",
                                  tb),
                 lambda: fs.phase(meta(1, 3, 16, 16), tb.B0_wg, tb.TT,
                                  "pre", tb)):
        with pytest.raises(ValueError, match="no kernel for a tensor"):
            call()
    assert not any(fs.launch_counts.values())


def test_kernel_sides_and_modes_are_checked():
    for side in fs.KERNEL_SIDES:
        fs.check_sides("ntt", side, side)
    for side in (8, 24, 256):
        with pytest.raises(ValueError, match="matrix sides"):
            fs.check_sides("ntt", 64, side)
    tb = fs.build_mxu_tables(MODS, 256, "cpu", C=16)
    x = torch.zeros((1, 3, 16, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="mode must be one of"):
        fs.phase(x, tb.A_wg, None, "middle", tb)
    with pytest.raises(ValueError, match="takes no grid"):
        fs.phase(x, tb.A_wg, tb.T, "none", tb)
    with pytest.raises(ValueError, match="needs a grid"):
        fs.phase(x, tb.A_wg, None, "pre", tb)
    with pytest.raises(ValueError, match="packed weights"):
        fs.phase(x, tb.A_dig, None, "none", tb)
    with pytest.raises(ValueError, match="not R \\* C"):
        fs.build_mxu_tables(MODS, 256, "cpu", C=48)


# ----------------------------------------------------------------------
# kernel 8's own tables and arithmetic, replayed on integers
# ----------------------------------------------------------------------
def _weights_from_layout(packed: np.ndarray, K: int) -> np.ndarray:
    """The (NDIG, K, K) planes a kernel reads from one limb's packed weights
    through wgmma's K-major canonical layout without swizzle, each plane
    padded to MP = 64 * ceil(K / 64) rows of depth KP = max(K, 32): element
    (i, k) of digit d at d * MP * KP + (i // 8) * 8 * KP + (k // 16) * 128
    + (i % 8) * 16 + k % 16; every other byte zero."""
    mp, kp = -(-K // 64) * 64, max(K, 32)
    assert packed.size == fs.NDIG * mp * kp
    i, k = np.meshgrid(np.arange(K), np.arange(K), indexing="ij")
    at = (i // 8) * 8 * kp + (k // 16) * 128 + (i % 8) * 16 + k % 16
    planes = packed.reshape(fs.NDIG, mp * kp)
    rest = planes.copy()
    rest[:, at] = 0
    assert not np.any(rest)
    return planes[:, at]


_N8192_PRIME = (int(BENCH_N8192.coeff_modulus[0]),)


@pytest.mark.parametrize("case", ["testnet.one", "bench.n8192",
                                  "non-square 512"])
def test_wgmma_layout_reads_back_planes(case, one_all):
    """The host's packing of every weight matrix into kernel 8's shared
    memory layout (wgmma's canonical K-major layout), read back through
    ``wgmma_weight_layout`` and through the layout's own formula, equals the
    plain [d][i][k] planes: sides 64 (q u Bsk of testnet.one), 128 and 64
    (bench.n8192), 32 and 16 (n = 512, C = 16)."""
    tb = {"testnet.one": lambda: one_all[0],
          "bench.n8192": lambda: fs.build_mxu_tables(_N8192_PRIME, 8192,
                                                     "cpu"),
          "non-square 512": lambda: fs.build_mxu_tables(MODS, 512, "cpu",
                                                        C=16)}[case]()
    for packed, planes in ((tb.A_wg, tb.A_dig),
                           (tb.B0_wg, tb.B0T_dig.transpose(-1, -2)),
                           (tb.Ai_wg, tb.Ai_dig),
                           (tb.B0i_wg, tb.B0iT_dig.transpose(-1, -2))):
        K = planes.shape[-1]
        idx = fs.wgmma_weight_layout(K)
        assert packed.dtype == torch.uint8 and packed.shape[1] == idx.size
        assert packed.is_contiguous()
        held = np.sort(idx[idx >= 0])
        assert np.array_equal(held, np.arange(fs.NDIG * K * K))
        for li in range(planes.shape[0]):
            f, want = packed[li].numpy(), planes[li].numpy()
            back = np.zeros(fs.NDIG * K * K, dtype=np.uint8)
            back[idx[idx >= 0]] = f[idx >= 0]
            assert not np.any(f[idx < 0])
            assert np.array_equal(back.reshape(want.shape), want)
            assert np.array_equal(_weights_from_layout(f, K), want)


def test_grid_shoup40_words_and_fold_scalars_equal_python_integers(one_all):
    tb = one_all[0]
    for li, p in enumerate(ALL):
        for words, shoup in ((tb.T, tb.T_shoup40), (tb.TiT, tb.TiT_shoup40)):
            w = _np(words[li]).reshape(-1)
            want = np.array([(int(v) << 40) // p for v in w], dtype=np.uint64)
            assert np.array_equal(_np(shoup[li]).reshape(-1), want)
        c32 = (1 << 32) % p
        assert [int(v) for v in _np(tb.fold_scalars[li])] == [
            p, c32, (c32 << 52) // p, (1 << 52) // p]
    assert torch.equal(tb.TiT, tb.Ti.transpose(-1, -2))


def _group_sums(w: np.ndarray, x: np.ndarray):
    """S_s = sum over da + db = s of W_da @ X_db: what each group of wgmma
    leaves in its s32 accumulators (w: (NDIG, K, K) digit planes, x: (K, N)
    words)."""
    xd = [((x >> (8 * d)) & 0xFF).astype(np.int64) for d in range(fs.NDIG)]
    sums = [np.zeros((w.shape[1], x.shape[1]), dtype=np.int64)
            for _ in range(2 * fs.NDIG - 1)]
    for da in range(fs.NDIG):
        for db in range(fs.NDIG):
            sums[da + db] += w[da].astype(np.int64) @ xd[db]
    return sums


def _shoup(a, w, ws, p, beta):
    """modmath.cuh shoup40_d on integers with the Shoup word
    ws = floor(w * 2^beta / p) scaled by 2^-beta: q = floor(a * ws / 2^beta)
    (the fma rounded down onto 2^52 needs that quotient below 2^52),
    a*w - q*p."""
    q = a * ws >> beta
    assert np.all(q < 1 << 52)
    return a * w - q * p


def _kernel8_product(w, x, K, p, c32, c32s, pinv):
    """One product of kernel 8, output by output as its epilogue forms it:
    a lazy value below 1.5p, every bound the comments state asserted."""
    sums = _group_sums(w, x)
    assert max(int(s.max()) for s in sums) < 5 * 255 ** 2 * K < 1 << 26
    lo = sum(sums[s].astype(object) << (8 * s) for s in range(4))
    hi = sum(sums[s].astype(object) << (8 * (s - 4)) for s in range(4, 9))
    assert max(lo.flat) < 1 << 51 and max(hi.flat) < 1 << 50
    r1 = _shoup(hi, c32, c32s, p, 52)
    assert min(r1.flat) >= 0 and max(r1.flat) < 2 * p
    x52 = lo + r1
    assert max(x52.flat) < 1 << 51
    r2 = _shoup(x52, 1, pinv, p, 52)
    assert min(r2.flat) >= 0 and max(r2.flat) < 3 * p // 2
    return r2


def _csub(a, p):
    return np.where(a >= p, a - p, a)


def _emulate_kernel8(x: np.ndarray, tb, inverse: bool) -> np.ndarray:
    """Kernel 8 on one (L, n) stack of rows from its own tables: the
    weights as read through the layout, fold_scalars, the grid and its
    beta = 40 Shoup words in the first product's output order."""
    R, C = tb.R, tb.C
    out = np.empty_like(x)
    for li in range(x.shape[0]):
        p, c32, c32s, pinv = (int(v) for v in _np(tb.fold_scalars[li]))
        wr = _weights_from_layout(
            (tb.Ai_wg if inverse else tb.A_wg)[li].numpy(), R)
        wc = _weights_from_layout(
            (tb.B0i_wg if inverse else tb.B0_wg)[li].numpy(), C)
        grid = _np((tb.TiT if inverse else tb.T)[li]).astype(object)
        grid_s = _np((tb.TiT_shoup40 if inverse else tb.T_shoup40)[li]
                     ).astype(object)
        m = x[li].reshape(R, C)
        w1, k1, op1 = (wc, C, m.T) if inverse else (wr, R, m)
        w2, k2 = (wr, R) if inverse else (wc, C)
        y = _kernel8_product(w1, op1, k1, p, c32, c32s, pinv)
        t = _shoup(y, grid, grid_s, p, 40)
        assert min(t.flat) >= 0 and np.all(t < p + (3 * p // 2) * p // 2 ** 40
                                           + 1)
        y = _csub(t, p).astype(np.uint64)
        z = _csub(_kernel8_product(w2, y.T, k2, p, c32, c32s, pinv), p)
        assert np.all(z < p)
        out[li] = (z if inverse else z.T).astype(np.uint64).reshape(-1)
    return out


@pytest.mark.parametrize("case", ["testnet.one", "n1024 R=16"])
def test_kernel8_steps_emulated_match_plain(case, one_all):
    """Kernel 8's arithmetic replayed on integers from the kernel's own
    tables, asserting every bound its comments state (the group sums, the
    lo/hi fold, each Shoup product's quotient and result), against
    ``ntt_plain`` / ``intt_plain`` (the latter with t folded in).  Rows:
    random, every residue p - 1, all zeros; the group-sum bound also for
    all-255 digits at K = 128."""
    if case == "testnet.one":
        mods, tb, tbi = ALL, one_all[0], one_all[0]
    else:
        mods = ALL[:2]
        tb = fs.build_mxu_tables(mods, 1024, "cpu")
        tbi = fs.build_mxu_tables(mods, 1024, "cpu",
                                  n_inv_factors=[TESTNET_ONE.t] * 2)
    x = _rand(np.random.default_rng(37), (3,), mods, tb.n)
    x[1] = np.array(mods, dtype=np.uint64)[:, None] - np.uint64(1)
    x[2] = 0
    for row in x:
        assert np.array_equal(_emulate_kernel8(row, tb, False),
                              _np(fs.ntt_plain(_t(row), tb)))
        assert np.array_equal(_emulate_kernel8(row, tbi, True),
                              _np(fs.intt_plain(_t(row), tbi)))
    ones = np.full((fs.NDIG, 128, 128), 255, dtype=np.uint8)
    worst = _group_sums(ones, np.full((128, 8), (1 << 40) - 1,
                                      dtype=np.uint64))
    assert max(int(s.max()) for s in worst) == 5 * 255 ** 2 * 128 < 1 << 26


def _grid_product(a: np.ndarray, w: np.ndarray, p: int) -> np.ndarray:
    """csrc/four_step.cu grid_mul_w on integers: h = a w rounded to the
    nearest double, q = floor(h * rinv) - 1 with rinv = 1 / p rounded (the
    fma's product exact), asserted within one of floor(a w / p) - 1
    (a < 1.5p), r = a w - q p asserted in [0, 3p), then two conditional
    subtracts."""
    rn, rd = (1.0 / p).as_integer_ratio()
    out = np.empty(a.shape, dtype=object)
    for at, (ai, wi) in enumerate(zip(a.flat, w.flat)):
        prod = int(ai) * int(wi)
        assert int(ai) < 3 * p // 2 and int(wi) < p
        hn, hd = float(prod).as_integer_ratio()
        q = hn * rn // (hd * rd) - 1
        assert q < 1 << 52 and abs(q - (prod // p - 1)) <= 1
        r = prod - q * p
        assert 0 <= r < 3 * p
        out.flat[at] = r - 2 * p if r >= 2 * p else r - p if r >= p else r
    return out


def _emulate_phase(x: np.ndarray, packed, grid, mode: str, tb) -> np.ndarray:
    """Kernel 9 on (rows, L, K, J) from its own tables: the weights as read
    through the layout, fold_scalars, the grid's words; "pre" multiplies
    each canonical input word by its grid word, the product is kernel 8's (a
    lazy value below 1.5p), then "post" takes the grid product and the
    other modes one conditional subtract."""
    K = x.shape[-2]
    out = np.empty_like(x)
    for li in range(x.shape[1]):
        p, c32, c32s, pinv = (int(v) for v in _np(tb.fold_scalars[li]))
        w = _weights_from_layout(packed[li].numpy(), K)
        g = None if grid is None else _np(grid[li])
        for b in range(x.shape[0]):
            m = x[b, li]
            if mode == "pre":
                m = _grid_product(m, g, p).astype(np.uint64)
            y = _kernel8_product(w, m, K, p, c32, c32s, pinv)
            y = _grid_product(y, g, p) if mode == "post" else _csub(y, p)
            assert np.all(y < p)
            out[b, li] = y.astype(np.uint64)
    return out


@pytest.mark.parametrize("mode", fs.PHASE_MODES)
@pytest.mark.parametrize("case", ["testnet.one 64 x 64", "16 x 32"])
def test_phase_kernel_steps_emulated_match_plain(case, mode, one_all):
    """Kernel 9's arithmetic replayed on integers from its own tables, each
    bound its comments state asserted (the grid products, and those of
    ``_kernel8_product``), against ``phase_plain`` and against Python
    integers: the two-launch forward's "pre" shape (B0, T transposed) and
    A's none / post.  Rows: random, every residue p - 1, all zeros."""
    if case == "testnet.one 64 x 64":
        mods, tb = ALL, one_all[0]
    else:
        mods, tb = MODS, fs.build_mxu_tables(MODS, 512, "cpu", C=16)
    packed, grid = (tb.B0_wg, tb.TT) if mode == "pre" else (tb.A_wg, tb.T)
    K, J = grid.shape[1:]
    if mode == "none":
        grid = None
    x = _rand(np.random.default_rng(38), (3,), mods, K * J)
    x[1] = np.array(mods, dtype=np.uint64)[:, None] - np.uint64(1)
    x[2] = 0
    x = x.reshape(3, len(mods), K, J)
    got = _emulate_phase(x, packed, grid, mode, tb)
    assert np.array_equal(got, _np(fs.phase_plain(_t(x), packed, grid, mode,
                                                  tb)))
    w = fs.unpack_wgmma(packed, K).numpy()
    for li, p in enumerate(mods):
        wl = sum(w[li, d].astype(object) << (8 * d) for d in range(fs.NDIG))
        g = None if grid is None else _np(grid[li]).astype(object)
        for b in range(3):
            xl = x[b, li].astype(object)
            want = wl.dot(xl * g % p if mode == "pre" else xl) % p
            if mode == "post":
                want = want * g % p
            assert np.array_equal(got[b, li], want.astype(np.uint64))


def test_phase_pre_equals_pallas_phase_interpret():
    """The forward's second launch, mode "pre" (B0 @ (T^T (*) Y^T)), against
    the Pallas kernel it replaces, ``PallasNtt._phase`` in interpret mode, on
    the same (C, R) matrices: one interpreted launch."""
    from fhe_precompiles_tpu.ops.pallas_ntt import PallasNtt
    pn = PallasNtt(MODS, 256, C=16, tb=4, interpret=True, fused=False)
    tb = fs.build_mxu_tables(MODS, 256, "cpu", C=16)
    L, C, R, B = len(MODS), tb.C, tb.R, 4
    x = _rand(np.random.default_rng(39), (B,), MODS, C * R).reshape(B, L, C,
                                                                     R)
    lo, hi = pn._to_pairs(jnp.asarray(
        x.transpose(1, 2, 0, 3).reshape(L, C, B * R)))
    out = pn._from_pairs(*pn._phase("pre", pn.b0_stack, pn.tT_pair,
                                    pn.tsT_pair, lo, hi, C, C, R, B))
    want = np.asarray(out, dtype=np.uint64).reshape(L, C, B, R
                                                    ).transpose(2, 0, 1, 3)
    got = fs.phase(_t(x), tb.B0_wg, tb.TT, "pre", tb)
    assert np.array_equal(_np(got), want)


def test_phase_fit_launches_every_side_pair():
    """``phase_fit`` (held against the library's ``fhe_four_step_phase_fit``
    at first launch) gives kernel 9 a batch at all 16 side pairs: at least
    one row, as many as fit up to MAX_ROWS, within the shared memory of one
    of two blocks an SM where the grid and one staged row fit there (the
    main shape, 64 x 64), else of one block."""
    two_blocks = fs.SM_SMEM // 2 - fs.BLOCK_RESERVED
    for K in fs.KERNEL_SIDES:
        for J in fs.KERNEL_SIDES:
            rows, grid_staged, in_staged, smem = fs.phase_fit(K, J)
            row = fs.NDIG * max(J, 32) * max(K, 32) + in_staged * 8 * K * J
            fixed = (fs.BARRIER_BYTES + fs.weight_bytes(K)
                     + grid_staged * 8 * K * J)
            budget = two_blocks if smem <= two_blocks else fs.MAX_SMEM
            assert 1 <= rows <= fs.MAX_ROWS
            assert smem == fixed + rows * row <= budget
            assert rows == fs.MAX_ROWS or smem + row > budget
    assert fs.phase_fit(64, 64) == (1, 1, 1, 106512)
    assert fs.phase_fit(128, 64) == (2, 1, 0, 229392)
    assert fs.phase_fit(128, 128) == (1, 0, 0, 163856)
    assert fs.phase_fit(64, 24) == (0, 0, 0, 0)


def _wide(n: int, count: int) -> BfvContext:
    return BfvContext(Params(poly_modulus_degree=n,
                             coeff_modulus=ntt_friendly_primes(n, count),
                             plain_modulus=4096))


def test_card_limits_refuse_what_the_kernels_cannot_take():
    """``TorchEngine(..., device="cuda")`` runs ``check_card_limits`` before
    it builds anything: a parameter set past a kernel's limit is refused at
    construction with the limit's name, where the JAX package computes it.
    Every preset fits."""
    for params in (TESTNET_ONE, BENCH_N8192):
        for backend in ("butterfly", "four_step"):
            check_card_limits(BfvContext(params), backend)
    wide_k = _wide(1024, 5)                       # k = 4
    for backend in ("butterfly", "four_step"):
        with pytest.raises(ValueError, match="MAX_K"):
            check_card_limits(wide_k, backend)
    with pytest.raises(ValueError, match="MAX_N"):
        check_card_limits(_wide(16384, 2), "butterfly")
    small = _wide(512, 2)                         # R = 512 / 64 = 8
    check_card_limits(small, "butterfly")
    with pytest.raises(ValueError, match="four-step NTT kernel"):
        check_card_limits(small, "four_step")
    assert fs.kernel_fit(128, 128) == (0, 0, 0)
    assert fs.kernel_fit(64, 64) == (2, 1, 188432)
    assert fs.kernel_fit(128, 64) == (1, 0, 184336)
    with pytest.raises(ValueError, match="do not fit"):
        fs.check_transform_fits("four_step_ntt", 128, 128)

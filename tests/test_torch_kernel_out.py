"""The kernel wrappers' ``out=``: the caller's buffer receives the words of
the call without it and is returned; a buffer of another shape, dtype or
layout is refused.  On the CPU the words are the plain version's (the card
writes them with the kernel; chip_smoke.py phase hardening passes its
guarded outputs this way).  Tolerance: none, every word equal.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from fhe_precompiles_tpu_torch.bfv import BfvContext
from fhe_precompiles_tpu_torch.ops import four_step as fs
from fhe_precompiles_tpu_torch.ops import ntt as tn
from fhe_precompiles_tpu_torch.ops import tail
from fhe_precompiles_tpu_torch.params import TESTNET_ONE

torch.set_num_threads(1)

MODS = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)     # tests/test_pallas_ntt.py
WRAPPERS = ("to_bsk_ext", "dyadic", "floor_sk", "relin_dot", "mod_down",
            "ntt", "intt", "four_step_ntt", "four_step_intt",
            "four_step_phase")


def _rand(rng, lead, mods, n):
    out = np.empty(lead + (len(mods), n), dtype=np.uint64)
    for li, p in enumerate(mods):
        out[..., li, :] = rng.integers(0, p, size=lead + (n,),
                                       dtype=np.uint64)
    return torch.from_numpy(out.view(np.int64))


@pytest.fixture(scope="module")
def calls():
    """Wrapper name -> a function of ``out`` that calls it on fixed
    inputs."""
    rng = np.random.default_rng(41)
    g = BfvContext(TESTNET_ONE)
    c = tail.TailConstants(g, "cpu")
    n, k, B = g.n, g.k, 2
    allm = g.q_mods + g.Bsk
    a = _rand(rng, (B, 2), g.q_mods, n)
    fa, fb = _rand(rng, (B, 2), allm, n), _rand(rng, (B, 2), allm, n)
    tq = _rand(rng, (B, 3), allm, n)
    d, rk = _rand(rng, (B, k), g.key_mods, n), _rand(rng, (k, 2), g.key_mods, n)
    acc, ct3 = _rand(rng, (B, 2), g.key_mods, n), _rand(rng, (B, 3), g.q_mods, n)
    btb = tn.build_tables(MODS, 512, "cpu")
    ftb = fs.build_mxu_tables(MODS, 512, "cpu", C=16)       # R = 32
    x = _rand(rng, (B,), MODS, 512)
    K, J = 16, 32
    m = _rand(rng, (B,), MODS, K * J).view(B, len(MODS), K, J)
    grid = _rand(rng, (), MODS, K * J).view(len(MODS), K, J)
    w = _rand(rng, (), MODS, K * K).numpy().view(np.uint64)
    packed = torch.from_numpy(fs.pack_wgmma(np.stack(
        [fs._digits(wl.reshape(K, K)) for wl in w])))
    return {
        "to_bsk_ext": lambda out: tail.to_bsk_ext(a, c, out=out),
        "dyadic": lambda out: tail.dyadic(fa, fb, c, out=out),
        "floor_sk": lambda out: tail.floor_sk(tq, c, out=out),
        "relin_dot": lambda out: tail.relin_dot(d, rk, c, out=out),
        "mod_down": lambda out: tail.mod_down(acc, ct3[:, :2], c, out=out),
        "ntt": lambda out: tn.ntt(x, btb, out=out),
        "intt": lambda out: tn.intt(x, btb, out=out),
        "four_step_ntt": lambda out: fs.ntt(x, ftb, out=out),
        "four_step_intt": lambda out: fs.intt(x, ftb, out=out),
        "four_step_phase": lambda out: fs.phase(m, packed, grid, "pre", ftb,
                                                out=out)}


@pytest.mark.parametrize("name", WRAPPERS)
def test_out_receives_the_words_and_is_returned(calls, name):
    want = calls[name](None)
    out = torch.full(want.shape, -1, dtype=torch.int64)
    got = calls[name](out)
    assert got is out
    assert torch.equal(out, want)


@pytest.mark.parametrize("name", WRAPPERS)
def test_out_of_another_shape_dtype_or_layout_is_refused(calls, name):
    want = calls[name](None)
    bad = (torch.empty(want.shape[:-1] + (want.shape[-1] + 1,),
                       dtype=torch.int64),
           torch.empty(want.shape, dtype=torch.int32),
           torch.empty(want.shape[:-1] + (2 * want.shape[-1],),
                       dtype=torch.int64)[..., ::2])
    for out in bad:
        with pytest.raises(ValueError, match=f"{name}: out must be"):
            calls[name](out)

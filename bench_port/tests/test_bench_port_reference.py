"""The reference against the program on the CPU, and the inputs against
their plaintexts.

* The reference's result of every request of a block equals, word for word,
  what ``RequestStream.run_pooled_fused`` on ``TorchEngine(device="cpu")``
  returns for it, on both of the stream's paths (pool larger than twice the
  multiplies: every operand prepared; pool smaller: each pooled ciphertext
  prepared once).
* Pool entries built as set-up builds them (the sums on the device) equal
  the reference's sums and decrypt to the sums of their plaintexts, on the
  cells' configurations too; a reference product decrypts to the negacyclic
  product of its operands' plaintexts mod t.
* Each plain op of the reference decrypts to its plaintext result, and each
  plain op's control decrypts to the same but changes the canonical words.
"""
import numpy as np
import pytest
import torch

from bench_port import check, manifest, traffic
from bench_port.inputs import make_inputs, pool_on_device
from bench_port.reference.golden import Ciphertext
from bench_port.tests import small

from fhe_precompiles_tpu_torch.bfv.golden import PublicKey, RelinKeys
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.params import Params
from fhe_precompiles_tpu_torch.parallel.stream import RequestStream


def program_stream(inp):
    params = Params(poly_modulus_degree=inp.ctx.n,
                    coeff_modulus=tuple(inp.ctx.params.coeff_modulus),
                    plain_modulus=inp.ctx.t)
    pk = PublicKey(params, inp.pk.data, RelinKeys(params, inp.pk.relin.data))
    return RequestStream(TorchEngine(params, device="cpu"),
                         max_batch=small.CONFIG["max_batch"]), pk


@pytest.mark.parametrize("pool", [64, 16])
def test_reference_equals_run_pooled_fused_word_for_word(pool):
    mix = small.mix(pool)
    inp = make_inputs(small.CONFIG, mix, seed=2 ** 31 + 5)
    block = traffic.make_blocks(mix, seed=2 ** 31 + 5)[0]
    stream, pk = program_stream(inp)
    out = stream.run_pooled_fused(block.ops, block.idx,
                                  pool_on_device(inp, "cpu"), pk)
    ref = check.Reference(inp)
    seen = 0
    for op, (idxs, arr) in out.items():
        host = arr.numpy().view(np.uint64)
        for slot, r in enumerate(idxs):
            a, b = (int(x) for x in block.idx[r])
            s = check.Sample(0, block.ops[r], r, a, b, host[slot])
            assert np.array_equal(s.got, ref.result(s)), (op, r)
            seen += 1
    assert seen == mix["requests"]


def negacyclic(a, b, t):
    n = len(a)
    full = np.convolve(a.astype(object), b.astype(object))
    out = full[:n].copy()
    out[:n - 1] -= full[n:]
    return np.array([int(x) % t for x in out], dtype=np.uint64)


def test_pool_entries_and_products_decrypt_to_their_plaintexts():
    mix = small.mix(64)
    inp = make_inputs(small.CONFIG, mix, seed=11)
    pool = pool_on_device(inp, "cpu").numpy().view(np.uint64)
    ctx, ref = inp.ctx, check.Reference(inp)
    for j in range(0, mix["pool"], 7):
        assert np.array_equal(pool[j], inp.pool_entry(j))
        assert np.array_equal(ctx.decrypt(ref.entry(j), inp.sk),
                              inp.pool_plain(j))
    s = check.Sample(0, "mul", 0, 3, 5, None)
    got = ctx.decrypt(ctx.mul_relin(ref.entry(3), ref.entry(5),
                                    inp.pk.relin), inp.sk)
    assert np.array_equal(got, negacyclic(inp.pool_plain(3),
                                          inp.pool_plain(5), ctx.t))
    assert np.array_equal(ref.result(s), ctx.mul_relin(
        ref.entry(3), ref.entry(5), inp.pk.relin).data)


@pytest.mark.parametrize("config",
                         [c["name"] for c in manifest.load()["configs"]])
def test_pool_entries_of_the_cells_configurations_decrypt(config):
    man = manifest.load()
    cfg = manifest.config(man, config)
    mix = dict(small.mix(16), pool=6)
    inp = make_inputs(cfg, mix, seed=2 ** 31 + 99)
    pool = pool_on_device(inp, "cpu")
    assert pool.dtype == torch.int64
    pool = pool.numpy().view(np.uint64)
    for j in (0, 5):
        assert np.array_equal(pool[j], inp.pool_entry(j))
        ct = check.Reference(inp).entry(j)
        assert np.array_equal(inp.ctx.decrypt(ct, inp.sk), inp.pool_plain(j))


def plain_result(op, m_a, m, t):
    """What `op` on a ciphertext of `m_a` and the plaintext `m` decrypts
    to."""
    if op == "mul_plain":
        return negacyclic(m_a, m, t)
    a, b = m_a.astype(np.int64), m.astype(np.int64)
    diff = {"add_plain": a + b, "sub_plain": a - b, "plain_sub": b - a}[op]
    return (diff % t).astype(np.uint64)


PAIRS = [(0, 0), (3, 5), (63, 15)]


@pytest.mark.parametrize("op", traffic.PLAIN_OPS)
def test_plain_ops_decrypt_to_their_plaintext_results(op):
    inp = make_inputs(small.CONFIG, small.plain_mix(), seed=2 ** 31 + 23)
    ctx, ref = inp.ctx, check.Reference(inp)
    assert inp.plain_pool.shape == (16, ctx.n)
    for a, b in PAIRS:
        got = ref.result(check.Sample(0, op, 0, a, b, None))
        assert got.shape == (2, ctx.k, ctx.n)
        assert np.array_equal(
            ctx.decrypt(Ciphertext(ctx.params, got), inp.sk),
            plain_result(op, inp.pool_plain(a), inp.plain_pool[b], ctx.t))


@pytest.mark.parametrize("op", traffic.PLAIN_OPS)
def test_plain_controls_decrypt_the_same_and_change_the_words(op):
    inp = make_inputs(small.CONFIG, small.plain_mix(), seed=2 ** 31 + 29)
    ctx, ref = inp.ctx, check.Reference(inp)
    for a, b in PAIRS[1:]:
        s = check.Sample(0, op, 0, a, b, None)
        want, control = ref.result(s), ref.control(s)
        assert np.array_equal(
            ctx.decrypt(Ciphertext(ctx.params, control), inp.sk),
            ctx.decrypt(Ciphertext(ctx.params, want), inp.sk))
        differ = control != want
        if op == "mul_plain":
            # the centred lift changes every word of the product
            assert differ.mean() > 0.99
        else:
            # rounding down changes the first component where the
            # canonical scale rounded up: about half its words
            assert differ[0].mean() > 0.4 and not differ[1].any()


def test_the_plain_pool_has_a_stream_of_its_own():
    seed = 2 ** 31 + 31
    a = make_inputs(small.CONFIG, small.plain_mix(), seed)
    b = make_inputs(small.CONFIG, small.mix(64), seed)
    for x, y in [(a.plains, b.plains), (a.fresh, b.fresh),
                 (a.terms, b.terms), (a.pk.data, b.pk.data),
                 (a.pk.relin.data, b.pk.relin.data)]:
        assert np.array_equal(x, y)
    assert a.plain_pool.shape == (16, a.ctx.n)
    assert b.plain_pool.shape == (0, b.ctx.n)
    assert a.plain_pool.max() < a.ctx.t
    assert not (a.plain_pool[:, None] == a.plains[None]).all(-1).any()

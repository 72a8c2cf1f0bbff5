"""The port's pooled request stream: a block planned once and uploaded once.

``parallel.stream.plan_block`` against the plain loop it replaces (the
groups, their order and each group's order), unknown ops, the batches a
``max_batch`` cuts, and ``RequestStream.run_pooled`` / ``run_pooled_fused``
on ``TorchEngine(device="cpu")`` against the golden model one request at a
time, word for word, on the prepared path (P <= 2 M) and the unprepared
one.  CPU cases run testnet.one's primes and t at n = 256.

The test marked ``card`` runs one block of 10,000 requests on the card
under ``torch.cuda.set_sync_debug_mode("error")`` until the call's final
synchronize, reads ``stream_counts`` and the launches of ``pooled_addsub``
(one an add or sub group) and holds the results to the same block on the
CPU engine; it skips without a CUDA device.  It imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_stream_plan.py
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.ops import pooled
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.params import TESTNET_ONE, Params
from fhe_precompiles_tpu_torch.parallel.stream import (
    OPS, RequestStream, plan_block, reset_stream_counts, stream_counts)

SMALL = Params(poly_modulus_degree=256,
               coeff_modulus=TESTNET_ONE.coeff_modulus,
               plain_modulus=TESTNET_ONE.plain_modulus)


def loop_groups(ops):
    """The plain loop: request indices by op, in first-appearance order."""
    order = {}
    for i, op in enumerate(ops):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        order.setdefault(op, []).append(i)
    return order


def shuffled(counts, seed):
    """A block holding counts[op] requests of each op, in a seeded order."""
    ops = [op for op in OPS for _ in range(counts.get(op, 0))]
    return [ops[i] for i in np.random.default_rng(seed).permutation(len(ops))]


MIXES = {
    "45/10/45 of 100": ({"add": 45, "sub": 10, "mul": 45}, 0),
    "45/10/45 of 100, another order": ({"add": 45, "sub": 10, "mul": 45}, 1),
    "45/10/45 of 10,000": ({"add": 4500, "sub": 1000, "mul": 4500}, 2),
    "add alone": ({"add": 7}, 3),
    "sub alone": ({"sub": 1}, 4),
    "mul alone": ({"mul": 9}, 5),
    "no add": ({"sub": 4, "mul": 6}, 6),
    "no sub": ({"add": 30, "mul": 30}, 7),
    "no mul": ({"add": 5, "sub": 5}, 8),
    "empty": ({}, 9),
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_plan_groups_and_order_equal_the_loop(mix):
    ops = shuffled(*MIXES[mix])
    plan = plan_block(ops)
    want = loop_groups(ops)
    got = plan.groups()
    assert list(got) == list(want)              # first-appearance order
    assert got == want                          # each group ascending
    assert plan.order.dtype == np.int64
    assert plan.starts == [0] + list(np.cumsum([len(v) for v in
                                                want.values()]))


@pytest.mark.parametrize("ops, bad", [
    (["add", "xyz"], "xyz"), (["mul", "ad"], "ad"), (["add|sub"], "add|sub"),
    (["sub", "mu|"], "mu|"), (["add", ""], ""), (["add", "Mul"], "Mul"),
    (["addé"], "addé"), (["add", 5], 5)])
def test_an_unknown_op_raises_naming_it(ops, bad):
    with pytest.raises(ValueError, match=re.escape(f"unknown op {bad!r}")):
        plan_block(ops)


# --------------------------------------------------------------------------
# the pooled calls against the golden model, request by request
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ctx = BfvContext(SMALL)
    pk, _ = ctx.generate_keys(seed=b"\x5a" * 64)
    return ctx, pk, TorchEngine(SMALL, device="cpu")


def random_pool(ctx, size, seed):
    """`size` ciphertexts of residues drawn below each ciphertext prime."""
    q = np.array(ctx.q_mods, dtype=np.uint64).reshape(1, 1, -1, 1)
    g = np.random.default_rng(seed)
    return g.integers(0, 1 << 63, size=(size, 2, ctx.k, ctx.n),
                      dtype=np.uint64) % q


def per_request(ctx, pk, op, a, b):
    ca, cb = Ciphertext(SMALL, a), Ciphertext(SMALL, b)
    if op == "add":
        return ctx.add(ca, cb).data
    if op == "sub":
        return ctx.sub(ca, cb).data
    return ctx.relinearize(ctx.multiply(ca, cb), pk.relin).data


# 5 multiplies: a pool of 4 takes the prepared path (P <= 2 M), 16 not
@pytest.mark.parametrize("pool_size", [4, 16], ids=["prepared", "unprepared"])
@pytest.mark.parametrize("max_batch", [1, 3, 8])
@pytest.mark.parametrize("call", ["run_pooled", "run_pooled_fused"])
def test_pooled_calls_equal_per_request(small, call, max_batch, pool_size):
    ctx, pk, eng = small
    ops = shuffled({"add": 6, "sub": 2, "mul": 5}, seed=max_batch)
    g = np.random.default_rng(pool_size)
    idx = g.integers(0, pool_size, size=(len(ops), 2))
    pool = random_pool(ctx, pool_size, seed=max_batch + pool_size)
    before = dict(stream_counts)
    res = getattr(RequestStream(eng, max_batch=max_batch), call)(
        ops, idx, torch.from_numpy(pool.view(np.int64)), pk)
    assert stream_counts == before              # counted on a card only
    groups = loop_groups(ops)
    if call == "run_pooled":
        # batches of each group in turn, cut every max_batch requests
        want = [(op, idxs[c:c + max_batch]) for op, idxs in groups.items()
                for c in range(0, len(idxs), max_batch)]
        assert [chunk for chunk, _ in res] == [chunk for _, chunk in want]
        res = [(op, chunk, arr) for (op, _), (chunk, arr) in zip(want, res)]
    else:
        assert list(res) == list(groups)
        res = [(op, idxs, arr) for op, (idxs, arr) in res.items()]
        assert [idxs for _, idxs, _ in res] == list(groups.values())
    for op, idxs, arr in res:
        assert arr.shape[0] == len(idxs)
        for slot, i in enumerate(idxs):
            want = per_request(ctx, pk, op, pool[idx[i][0]], pool[idx[i][1]])
            assert np.array_equal(arr[slot].numpy().view(np.uint64), want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda")


# a pool of 256 takes the prepared path, one of 10,240 the unprepared
@pytest.mark.card
@pytest.mark.parametrize("pool_size", [256, 10240])
def test_a_block_on_the_card_waits_only_at_its_end(card, pool_size):
    ctx = BfvContext(TESTNET_ONE)
    pk, _ = ctx.generate_keys(seed=b"\x5b" * 64)
    ops = shuffled({"add": 4500, "sub": 1000, "mul": 4500}, seed=pool_size)
    idx = np.random.default_rng(pool_size).integers(
        0, pool_size, size=(len(ops), 2))
    host_pool = torch.from_numpy(random_pool(ctx, pool_size, 1).view(np.int64))
    stream = RequestStream(TorchEngine(TESTNET_ONE, device=card))
    pool = host_pool.to(card)
    stream.run_pooled_fused(ops, idx, pool, pk)     # builds, allocates
    torch.cuda.synchronize(card)

    final = stream._sync

    def final_sync():
        torch.cuda.set_sync_debug_mode("default")
        final()

    stream._sync = final_sync
    reset_stream_counts()
    pooled.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = stream.run_pooled_fused(ops, idx, pool, pk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stream_counts == {"plan_uploads": 1, "waits": 1}
    assert pooled.launch_counts == {"pooled_addsub": 2}   # add, sub groups

    want = RequestStream(TorchEngine(TESTNET_ONE, device="cpu")
                         ).run_pooled_fused(ops, idx, host_pool, pk)
    assert list(got) == list(want)
    for op, (idxs, arr) in want.items():
        assert got[op][0] == idxs
        assert torch.equal(got[op][1].cpu(), arr), op

"""A pooled block's add and sub groups: ``ops/pooled.py`` ``pooled_addsub``.

On the CPU the wrapper's plain version (the gathers, then ``addmod`` /
``submod``) is held to the golden model request by request, at testnet.one's
primes and n = 256: repeated indices, a == b, residues at 0 and p - 1, a
pool of one.  Zero requests give an empty result and no launch; the
stream's pooled calls run each add or sub group through the wrapper (on the
card once a group in ``run_pooled_fused``, on the CPU once a batch of at
most ``max_batch`` written into the group's one result; once a batch in
``run_pooled``), and an
operand index outside the pool raises ``IndexError`` naming its request
before anything runs.  Tolerance: none, every word equal.

The tests marked ``card`` hold the kernel to its plain version on the card,
word for word, at the stream's shapes; they skip without a CUDA device.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_pooled.py
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.ops import pooled
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.ops.pooled import (pooled_addsub,
                                                  pooled_addsub_plain)
from fhe_precompiles_tpu_torch.params import TESTNET_ONE, Params
from fhe_precompiles_tpu_torch.parallel import stream as stream_mod
from fhe_precompiles_tpu_torch.parallel.stream import (RequestStream,
                                                       stream_counts)

SMALL = Params(poly_modulus_degree=256,
               coeff_modulus=TESTNET_ONE.coeff_modulus,
               plain_modulus=TESTNET_ONE.plain_modulus)
Q = list(TESTNET_ONE.coeff_modulus[:-1])        # the two ciphertext primes


def edge_pool(size, n, seed):
    """`size` ciphertexts (size, 2, k, n) uint64: row 0 all zeros, row 1 all
    p - 1, row 2 zeros and p - 1 alternating, the rest uniform residues
    (as many of the three as `size` holds)."""
    q = np.array(Q, dtype=np.uint64).reshape(1, 1, -1, 1)
    g = np.random.default_rng(seed)
    pool = g.integers(0, 1 << 63, size=(size, 2, len(Q), n),
                      dtype=np.uint64) % q
    top = np.broadcast_to(q[0] - 1, (2, len(Q), n))
    edges = [np.zeros((2, len(Q), n), dtype=np.uint64), top,
             np.where(np.arange(n) % 2 == 0, 0, top).astype(np.uint64)]
    for r, row in enumerate(edges[:size]):
        pool[r] = row
    return pool


@pytest.fixture(scope="module")
def ctx():
    return BfvContext(SMALL)


def golden(ctx, op, a, b):
    ca, cb = Ciphertext(SMALL, a), Ciphertext(SMALL, b)
    return (ctx.add(ca, cb) if op == "add" else ctx.sub(ca, cb)).data


# (pool size, (a, b) pairs): each pair a request
CASES = {
    "a pool of one": (1, [(0, 0)]),
    "a == b on every edge row": (3, [(0, 0), (1, 1), (2, 2)]),
    "zeros against p - 1 both ways": (3, [(0, 1), (1, 0), (2, 1), (1, 2),
                                          (0, 2), (2, 0)]),
    "repeated indices": (5, [(4, 3), (4, 3), (3, 4), (4, 4), (4, 3), (0, 4)]),
    "uniform, the last row included": (16, [(i, 15 - i) for i in range(16)]
                                       + [(15, 15), (7, 15)]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", ["add", "sub"])
def test_plain_version_equals_the_golden_model(ctx, op, case):
    size, pairs = CASES[case]
    pool = edge_pool(size, ctx.n, seed=size)
    ia = torch.tensor([a for a, _ in pairs], dtype=torch.int64)
    ib = torch.tensor([b for _, b in pairs], dtype=torch.int64)
    got = pooled_addsub(torch.from_numpy(pool.view(np.int64)), ia, ib, Q,
                        op == "sub")
    assert got.shape == (len(pairs), 2, len(Q), ctx.n)
    for r, (a, b) in enumerate(pairs):
        want = golden(ctx, op, pool[a], pool[b])
        assert np.array_equal(got[r].numpy().view(np.uint64), want), (op, r)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_plain_version_is_the_engines_arithmetic(op):
    """The same words as ``TorchEngine._add`` / ``_sub`` on the gathered
    operands: the CPU engine's bytes did not move."""
    eng = TorchEngine(SMALL, device="cpu")
    pool = torch.from_numpy(edge_pool(16, SMALL.n, seed=3).view(np.int64))
    g = np.random.default_rng(4)
    ia, ib = (torch.from_numpy(g.integers(0, 16, size=40)) for _ in "ab")
    a, b = pool.index_select(0, ia), pool.index_select(0, ib)
    want = eng._sub(a, b) if op == "sub" else eng._add(a, b)
    assert torch.equal(pooled_addsub_plain(pool, ia, ib, Q, op == "sub"),
                       want)


def test_zero_requests_give_an_empty_result_and_no_launch():
    pool = torch.from_numpy(edge_pool(3, 8, seed=0).view(np.int64))
    none = torch.empty(0, dtype=torch.int64)
    pooled.reset_launch_counts()
    for sub in (False, True):
        got = pooled_addsub(pool, none, none, Q, sub)
        assert got.shape == (0, 2, len(Q), 8)
        assert got.dtype == torch.int64
    assert pooled.launch_counts == {"pooled_addsub": 0}


def test_a_tensor_off_the_cpu_and_off_the_card_is_refused():
    meta = torch.empty((4, 2, len(Q), 8), dtype=torch.int64, device="meta")
    idx = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for a tensor"):
        pooled_addsub(meta, idx, idx, Q, False)
    assert pooled.launch_counts["pooled_addsub"] == 0


# --------------------------------------------------------------------------
# the stream's pooled calls
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ctx = BfvContext(SMALL)
    pk, _ = ctx.generate_keys(seed=b"\x5c" * 64)
    return pk, TorchEngine(SMALL, device="cpu")


def counting(monkeypatch):
    """Records the (op, rows) of every ``pooled_addsub`` the stream
    calls."""
    calls = []

    def wrapper(pool, ia, ib, q, sub, **kw):
        calls.append(("sub" if sub else "add", ia.shape[0]))
        return pooled_addsub(pool, ia, ib, q, sub, **kw)

    monkeypatch.setattr(stream_mod, "pooled_addsub", wrapper)
    return calls


@pytest.mark.parametrize("max_batch", [1, 4, 1024])
def test_fused_call_runs_each_add_and_sub_group_once(small, monkeypatch,
                                                     max_batch):
    pk, eng = small
    ops = ["add"] * 9 + ["sub"] * 5 + ["mul"] * 2
    ops = [ops[i] for i in np.random.default_rng(5).permutation(len(ops))]
    idx = np.random.default_rng(6).integers(0, 8, size=(len(ops), 2))
    pool = torch.from_numpy(edge_pool(8, SMALL.n, seed=7).view(np.int64))
    calls = counting(monkeypatch)
    res = RequestStream(eng, max_batch=max_batch).run_pooled_fused(
        ops, idx, pool, pk)
    # on the CPU the plain version runs a batch at a time: each request of
    # each group once, in calls of at most max_batch rows
    assert sorted(calls) == sorted(
        (op, min(max_batch, m - c)) for op, m in (("add", 9), ("sub", 5))
        for c in range(0, m, max_batch))
    for op in ("add", "sub"):
        idxs, arr = res[op]
        want = pooled_addsub_plain(pool, torch.from_numpy(idx[idxs, 0]),
                                   torch.from_numpy(idx[idxs, 1]), Q,
                                   op == "sub")
        assert torch.equal(arr, want)


def test_run_pooled_calls_the_wrapper_once_a_batch(small, monkeypatch):
    pk, eng = small
    ops = ["sub"] * 5 + ["add"] * 9
    idx = np.random.default_rng(8).integers(0, 4, size=(len(ops), 2))
    pool = torch.from_numpy(edge_pool(4, SMALL.n, seed=9).view(np.int64))
    calls = counting(monkeypatch)
    res = RequestStream(eng, max_batch=4).run_pooled(ops, idx, pool, pk)
    assert calls == [("sub", 4), ("sub", 1), ("add", 4), ("add", 4),
                     ("add", 1)]
    assert [len(chunk) for chunk, _ in res] == [4, 1, 4, 4, 1]


# (request, side, index) put into a block of 12 requests on a pool of 6
BAD = [(0, 0, 6), (5, 1, 6), (11, 0, -1), (3, 1, -7), (7, 0, 1 << 40)]


@pytest.mark.parametrize("request_, side, bad", BAD)
@pytest.mark.parametrize("call", ["run_pooled", "run_pooled_fused"])
def test_an_index_outside_the_pool_raises_before_anything_runs(
        small, monkeypatch, call, request_, side, bad):
    pk, eng = small
    ops = ["add", "sub", "mul"] * 4
    idx = np.random.default_rng(10).integers(0, 6, size=(len(ops), 2))
    idx[request_, side] = bad
    pool = torch.from_numpy(edge_pool(6, SMALL.n, seed=11).view(np.int64))
    calls = counting(monkeypatch)
    muls = []
    monkeypatch.setattr(eng, "_mul_relin", lambda *a: muls.append(a))
    monkeypatch.setattr(eng, "_prepare", lambda *a: muls.append(a))
    before = dict(stream_counts)
    stream = RequestStream(eng, max_batch=4)
    with pytest.raises(IndexError, match=re.escape(
            f"request {request_}: operand indices {idx[request_].tolist()} "
            "outside the pool of 6 ciphertexts")):
        getattr(stream, call)(ops, idx, pool, pk)
    assert stream_counts == before
    assert calls == [] and muls == []


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda")


def card_pool(size, n, seed, device):
    """`size` ciphertexts of uniform residues at testnet.one's primes, made
    on the card; its first rows are edge_pool's edge rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, (size, 2, len(Q), n), generator=g,
                      device=device)
    x %= torch.tensor(Q, device=device).view(1, 1, -1, 1)
    edges = torch.from_numpy(edge_pool(min(size, 3), n, seed).view(np.int64))
    x[:edges.shape[0]] = edges.to(device)
    return x


@pytest.mark.card
@pytest.mark.parametrize("P", [1, 256, 10240])
@pytest.mark.parametrize("M", [1, 3, 1023, 4500])
def test_kernel_equals_its_plain_version_on_the_card(card, M, P):
    n = TESTNET_ONE.poly_modulus_degree
    pool = card_pool(P, n, seed=P, device=card)
    g = torch.Generator(device=card).manual_seed(M)
    ia = torch.randint(0, P, (M,), generator=g, device=card)
    ib = torch.randint(0, P, (M,), generator=g, device=card)
    ia[0] = P - 1                                   # the pool's last row
    pooled.reset_launch_counts()
    for sub in (False, True):
        got = pooled_addsub(pool, ia, ib, Q, sub)
        want = pooled_addsub_plain(pool, ia, ib, Q, sub)
        torch.cuda.synchronize(card)
        assert torch.equal(got, want), ("sub" if sub else "add", M, P)
    assert pooled.launch_counts == {"pooled_addsub": 2}


@pytest.mark.card
@pytest.mark.parametrize("n, M", [(8, 70000), (256, 5)],
                         ids=["rows beyond a grid dimension",
                              "a partial block of a row"])
def test_kernel_at_other_shapes_on_the_card(card, n, M):
    pool = card_pool(256, n, seed=n, device=card)
    g = torch.Generator(device=card).manual_seed(n)
    ia, ib = (torch.randint(0, 256, (M,), generator=g, device=card)
              for _ in "ab")
    for sub in (False, True):
        out = torch.full((M, 2, len(Q), n), -1, dtype=torch.int64,
                         device=card)
        got = pooled_addsub(pool, ia, ib, Q, sub, out=out)
        assert got is out
        assert torch.equal(got, pooled_addsub_plain(pool, ia, ib, Q, sub))


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take_on_the_card(card):
    n = 64
    pool = card_pool(4, n, seed=1, device=card)
    idx = torch.tensor([0, 3, 1], dtype=torch.int64, device=card)
    wide = torch.empty((3, 2, len(Q), 2 * n), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="pooled_addsub: out must be"):
        pooled_addsub(pool, idx, idx, Q, False, out=wide[..., ::2])
    with pytest.raises(ValueError, match="expected a contiguous tensor"):
        pooled_addsub(pool[:, :, :, ::2], idx, idx, Q, False)
    with pytest.raises(ValueError, match="expected shape"):
        pooled_addsub(pool, idx, idx, Q[:1], False)
    with pytest.raises(TypeError, match="expected torch.int64"):
        pooled_addsub(pool, idx.int(), idx, Q, False)
    pooled.reset_launch_counts()
    zero = pooled_addsub(pool, idx[:0], idx[:0], Q, True)
    assert zero.shape == (0, 2, len(Q), n)
    assert pooled.launch_counts == {"pooled_addsub": 0}

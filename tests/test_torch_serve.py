"""The port's request stream and batched byte server against the JAX
package's.

``parallel.stream.RequestStream`` (``run``, ``run_pooled``,
``run_pooled_fused``) on ``TorchEngine(device="cpu")``, where every kernel
wrapper runs its plain version, against per-request golden results and the
JAX package's ``RequestStream`` on the same requests; ``serve.ByteServer``
(python codec) against ``FheApp.call`` one at a time, the JAX package's
golden app and its ``ByteServer(codec="python")``: equal bytes and codes
(tolerance 0), in input order, with the fallbacks counted by reason; an
injected device fault that degrades; continuous mode.  Streams are small
(at most 24 requests, 2 keys, ``max_batch`` 4) on ``testnet.one``.  Every
wait on a future has a timeout, so that a hang fails at once.
"""
import dataclasses
import hashlib
import threading
import time

import numpy as np
import pytest

from fhe_precompiles_tpu import FheApp as JFheApp
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE
from fhe_precompiles_tpu.parallel.stream import Request as JRequest
from fhe_precompiles_tpu.parallel.stream import bucket_batch as j_bucket
from fhe_precompiles_tpu.serve import BINARY_SPECS as J_BINARY_SPECS
from fhe_precompiles_tpu.serialization import keyio as j_keyio
from fhe_precompiles_tpu.serve import ByteServer as JByteServer

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import FheApp, metrics, pack
from fhe_precompiles_tpu_torch.app import _CT_CODEC
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.parallel import (Request, RequestStream,
                                                bucket_batch)
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
from fhe_precompiles_tpu_torch.serve import (BINARY_SPECS, FALLBACK_REASONS,
                                             ByteServer)

MAX_BATCH = 4
VALUES = (2, 3, 4, 5)
TIMEOUT = 30          # seconds a future may take; a hang fails at once


@pytest.fixture(scope="module")
def ctx():
    return BfvContext(TESTNET_ONE)


@pytest.fixture(scope="module")
def keys(ctx):
    return (ctx.generate_keys(seed=b"\x61" * 64),
            ctx.generate_keys(seed=b"\x62" * 64))


@pytest.fixture(scope="module")
def apps():
    return {"torch": FheApp(TESTNET_ONE, engine="torch", device="cpu"),
            "golden": FheApp(TESTNET_ONE), "jax_golden": JFheApp(J_ONE)}


@pytest.fixture(scope="module")
def server(apps):
    with ByteServer(TESTNET_ONE, app=apps["torch"], max_batch=MAX_BATCH,
                    workers=4) as s:
        yield s


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's server on its jax engine; its stream is the JAX
    ``RequestStream`` the port's is held against (one engine, one set of
    compiled programs)."""
    app = JFheApp(J_ONE, engine="jax")
    s = JByteServer(J_ONE, app=app, max_batch=MAX_BATCH, codec="python",
                    workers=4)
    yield s
    s.close()


def _ct(ctx, value, tname, pk, tag: bytes) -> Ciphertext:
    poly = PLAIN_TYPES[tname].encode(value, TESTNET_ONE)
    return ctx.encrypt(poly, pk, hashlib.sha512(tag).digest())


@pytest.fixture(scope="module")
def sample_cts(ctx, keys):
    pk = keys[0][0]
    return [_ct(ctx, v, "u64", pk, b"s%d" % v) for v in VALUES]


def _binary(pk, a, b, ca=_CT_CODEC, cb=_CT_CODEC):
    return pack.pack_binary_operation(pk, a, ca, b, cb)


@pytest.fixture(scope="module")
def mixed(ctx, keys, apps):
    """23 requests: the 12 cipher∘cipher ops under two keys, then the
    per-request surface (cp, pc, encrypt, decrypt, reencrypt,
    public_key_bytes), three errors and two size-3 ciphertexts (the
    counterpart of test_serve.py's stream)."""
    (pk1, _), (pk2, _) = keys
    net_pk = apps["golden"].public_key
    reqs = []
    for tname, pk, tag in (("u64", pk1, b"a"), ("i64", pk1, b"b"),
                           ("frac64", pk2, b"c"), ("u256", pk2, b"d")):
        four = 4.0 if tname == "frac64" else 4
        a = _ct(ctx, 16, tname, pk, tag + b"1")
        b = _ct(ctx, four, tname, pk, tag + b"2")
        for op in ("add", "sub", "mul"):
            reqs.append((f"{op}_cipher{tname}_cipher{tname}",
                         _binary(pk, a, b)))
    a = _ct(ctx, 16, "u64", pk1, b"e1")
    reqs.append(("mul_cipheru64_u64", _binary(pk1, a, 4, cb=pack.U64)))
    reqs.append(("add_u64_cipheru64", _binary(pk1, 4, a, ca=pack.U64)))
    reqs.append(("encrypt_u64",
                 pack.pack_two_arguments(12, pack.U64, b"\x01", pack.BYTES)))
    net_ct = _ct(ctx, 7, "u64", net_pk, b"net")
    reqs.append(("decrypt_u64", pack.pack_one_argument(net_ct, _CT_CODEC)))
    reqs.append(("reencrypt_u64", _binary(net_pk, net_ct, b"\x02",
                                          cb=pack.BYTES)))
    reqs.append(("public_key_bytes", b""))
    reqs.append(("mul_cipheru64_nope", b"\x00\x01"))
    reqs.append(("add_cipheru64_cipheru64", b"\x00\x00\x00\x08trunc"))
    b2 = _ct(ctx, 4, "u64", pk1, b"f2")
    reqs.append(("mul_cipheru64_cipheru64",
                 _binary(dataclasses.replace(pk1, relin=None), a, b2)))
    c3 = ctx.multiply(a, b2)
    reqs.append(("add_cipheru64_cipheru64", _binary(pk1, c3, c3)))
    reqs.append(("decrypt_u64", pack.pack_one_argument(
        ctx.multiply(_ct(ctx, 2, "u64", net_pk, b"n3a"),
                     _ct(ctx, 3, "u64", net_pk, b"n3b")), _CT_CODEC)))
    return reqs


@pytest.fixture(scope="module")
def expected(apps, mixed):
    return [apps["torch"].call(name, data) for name, data in mixed]


def _delta(server, before):
    return {r: server.fallbacks[r] - before.get(r, 0)
            for r in FALLBACK_REASONS}


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def test_binary_specs_are_the_jax_packages():
    assert BINARY_SPECS == J_BINARY_SPECS and len(BINARY_SPECS) == 36


@pytest.mark.parametrize("m", [3, 100, 128])
def test_bucket_batch_never_exceeds_max_batch(m):
    for n in range(1, m + 1):
        got = bucket_batch(n, 1, m)
        assert n <= got <= m, (n, m, got)
        # where the JAX package's bucket fits, it is the same
        if j_bucket(n, 1, m) <= m:
            assert got == j_bucket(n, 1, m)
    assert bucket_batch(m + 1, 1, m) >= m + 1


def _per_request(ctx, pk, op, a, b) -> np.ndarray:
    ca, cb = Ciphertext(TESTNET_ONE, a), Ciphertext(TESTNET_ONE, b)
    if op == "add":
        return ctx.add(ca, cb).data
    if op == "sub":
        return ctx.sub(ca, cb).data
    return ctx.relinearize(ctx.multiply(ca, cb), pk.relin).data


def test_make_mixed_requests_is_the_jax_packages(server, jax_server,
                                                 sample_cts):
    ours = server.stream.make_mixed_requests(sample_cts, 40, seed=3)
    theirs = jax_server.stream.make_mixed_requests(sample_cts, 40, seed=3)
    assert [r.op for r in ours] == [str(r.op) for r in theirs]
    for r, s in zip(ours, theirs):
        assert r.a is s.a and r.b is s.b


def test_stream_run_equals_the_jax_stream_and_per_request(
        ctx, keys, server, jax_server, sample_cts):
    pk = keys[0][0]
    reqs = server.stream.make_mixed_requests(sample_cts, 10, seed=7)
    assert {r.op for r in reqs} == {"add", "sub", "mul"}
    got = server.stream.run(reqs, pk)
    theirs = jax_server.stream.run(
        [JRequest(r.op, r.a, r.b) for r in reqs],
        j_keyio.load_public_key(pk.to_bytes()))
    for r, ours, jax_out in zip(reqs, got, theirs):
        assert ours.dtype == np.uint64
        assert np.array_equal(ours, jax_out), r.op
        assert np.array_equal(ours, _per_request(ctx, pk, r.op, r.a, r.b))


def test_stream_refuses_mul_without_relin_keys(server, keys, sample_cts):
    pk = dataclasses.replace(keys[0][0], relin=None)
    reqs = [Request("mul", sample_cts[0].data, sample_cts[1].data)]
    with pytest.raises(ValueError, match="relin keys"):
        server.stream.run(reqs, pk)
    assert server.stream.run(
        [Request("add", sample_cts[0].data, sample_cts[1].data)], pk)


def _pool_case(sample_cts, n, ops, seed):
    rng = np.random.default_rng(seed)
    pool = np.stack([c.data for c in sample_cts])
    return (list(rng.choice(ops, size=n)),
            rng.integers(0, len(sample_cts), size=(n, 2)), pool)


def test_run_pooled_equals_per_request(ctx, keys, server, sample_cts):
    pk = keys[0][0]
    ops, idx, pool = _pool_case(sample_cts, 10, ["add", "sub", "mul"], 5)
    batches = server.stream.run_pooled(ops, idx, pool, pk)
    seen = []
    for chunk, arr in batches:
        assert len(chunk) <= MAX_BATCH and arr.shape[0] == len(chunk)
        for slot, i in enumerate(chunk):
            want = _per_request(ctx, pk, ops[i], pool[idx[i][0]],
                                pool[idx[i][1]])
            assert np.array_equal(arr[slot].numpy().view(np.uint64), want)
            seen.append(i)
    assert sorted(seen) == list(range(10))


@pytest.mark.parametrize("n_mul", [1, 6])
def test_run_pooled_fused_equals_per_request(ctx, keys, server, sample_cts,
                                             n_mul):
    """6 multiplies on a pool of 4 take the prepared path (P <= 2 M), 1
    multiply the unprepared one."""
    pk = keys[0][0]
    _, idx, pool = _pool_case(sample_cts, n_mul + 3, ["add"], 6)
    ops = ["mul"] * n_mul + ["add", "sub", "add"]
    res = server.stream.run_pooled_fused(ops, idx, pool, pk)
    assert set(res) == set(ops)
    for op, (idxs, arr) in res.items():
        assert arr.shape[0] == len(idxs)
        for slot, i in enumerate(idxs):
            want = _per_request(ctx, pk, op, pool[idx[i][0]],
                                pool[idx[i][1]])
            assert np.array_equal(arr[slot].numpy().view(np.uint64), want)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def test_server_equals_fheapp_call_and_the_jax_golden_app(
        server, apps, mixed, expected):
    before = dict(server.fallbacks)
    got = server.run(mixed)
    assert len(got) == len(mixed)
    for (name, data), res, want in zip(mixed, got, expected):
        assert res == want, name
        assert res == apps["jax_golden"].call(name, data), name
    # 7 per-request names, one size-3 cipher∘cipher; no batched op fell back
    assert _delta(server, before) == {"not_batchable": 7,
                                      "ciphertext_size": 1, "device": 0,
                                      "encode": 0}
    assert set(server.last_split_ms) == {"decode", "device", "encode",
                                         "fallback"}


def test_server_equals_the_jax_byte_server(server, jax_server, mixed):
    """The cipher∘cipher block, which both servers batch."""
    reqs = mixed[:12]
    assert server.run(reqs) == jax_server.run(reqs)


def test_server_preserves_input_order(ctx, keys, server, apps):
    (pk1, _), (pk2, _) = keys
    a1, b1 = (_ct(ctx, v, "u64", pk1, b"o%d" % v) for v in (3, 5))
    a2, b2 = (_ct(ctx, v, "u64", pk2, b"o%d" % v) for v in (9, 2))
    reqs = []
    for _ in range(3):
        reqs.append(("add_cipheru64_cipheru64", _binary(pk1, a1, b1)))
        reqs.append(("sub_cipheru64_cipheru64", _binary(pk2, a2, b2)))
        reqs.append(("public_key_bytes", b""))
    got = server.run(reqs)
    for (name, data), res in zip(reqs, got):
        assert res == apps["torch"].call(name, data), name


def test_device_fault_degrades_and_is_counted(server, mixed, expected,
                                              monkeypatch):
    def fail(*_a, **_k):
        raise RuntimeError("injected")
    monkeypatch.setattr(server.stream, "run", fail)
    before = dict(server.fallbacks)
    assert server.run(mixed) == expected
    # the 12 cipher∘cipher ops of two keys: two groups, each degraded
    assert _delta(server, before)["device"] == 12


def test_server_refuses_other_engines_and_unknown_codecs(apps):
    with pytest.raises(ValueError, match="engine='torch'"):
        ByteServer(TESTNET_ONE, app=apps["golden"])
    with pytest.raises(ValueError, match="engine='torch'"):
        ByteServer(TESTNET_ONE, app=apps["golden"], codec="native")
    with pytest.raises(ValueError, match="unknown codec"):
        ByteServer(TESTNET_ONE, app=apps["torch"], codec="rust")


def test_server_metrics(server, mixed):
    metrics.GLOBAL.reset()
    metrics.enable()
    try:
        server.run(mixed[:3])
        snap = metrics.GLOBAL.snapshot()
    finally:
        metrics.disable()
        metrics.GLOBAL.reset()
    for name, data in mixed[:3]:
        assert snap[name].count == 1 and snap[name].bytes_in == len(data)


# ---------------------------------------------------------------------------
# continuous mode
# ---------------------------------------------------------------------------

def test_continuous_mode_matches_fheapp_call(server, mixed, expected):
    server.start_continuous(flush_ms=5.0)
    try:
        futs = [server.submit(name, data) for name, data in mixed]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        server.stop_continuous()
    assert got == expected


def test_continuous_lone_request_answers_promptly(server, mixed, expected):
    server.start_continuous(flush_ms=2.0, max_window=10_000)
    try:
        t0 = time.monotonic()
        res = server.submit(*mixed[0]).result(timeout=TIMEOUT)
        dt = time.monotonic() - t0
    finally:
        server.stop_continuous()
    assert res == expected[0]
    # flush_ms and one add: milliseconds, not "until the window fills"
    assert dt < 5.0


def test_continuous_drains_on_stop(server, mixed, expected):
    server.start_continuous(flush_ms=50.0)
    futs = [server.submit(name, data) for name, data in mixed[:6]]
    server.stop_continuous()          # must drain, not drop
    assert [f.result(timeout=1) for f in futs] == expected[:6]


def test_submit_requires_started_loop(server):
    with pytest.raises(RuntimeError, match="start_continuous"):
        server.submit("public_key_bytes", b"")
    server.start_continuous()
    with pytest.raises(RuntimeError, match="already running"):
        server.start_continuous()
    server.stop_continuous()
    server.stop_continuous()          # idempotent
    with pytest.raises(RuntimeError, match="start_continuous"):
        server.submit("public_key_bytes", b"")


def test_cancelled_future_neither_hangs_nor_breaks_later_submits(
        server, mixed, expected):
    server.start_continuous(flush_ms=200.0)
    try:
        cancelled = server.submit(*mixed[0])
        assert cancelled.cancel()
        same_window = server.submit(*mixed[1])
        assert same_window.result(timeout=TIMEOUT) == expected[1]
        later = server.submit(*mixed[2])
        assert later.result(timeout=TIMEOUT) == expected[2]
        assert cancelled.cancelled()
        loop = server._cthread
    finally:
        server.stop_continuous()
    assert not loop.is_alive()


def test_concurrent_submitters(server, mixed, expected):
    """Eight threads submit at once; every future gets its own answer."""
    server.start_continuous(flush_ms=5.0)
    results = {}
    try:
        def submitter(j):
            for i in range(j, 12, 4):
                results[i] = server.submit(*mixed[i])
        threads = [threading.Thread(target=submitter, args=(j,))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        got = {i: f.result(timeout=TIMEOUT) for i, f in results.items()}
    finally:
        server.stop_continuous()
    assert got == {i: expected[i] for i in range(12)}

"""The port's ``ByteServer(codec="native")`` against ``FheApp.call`` and the
JAX package's golden app.

The server runs on ``FheApp(engine="torch", device="cpu")`` (every kernel
wrapper on its plain version) with ``max_batch`` 4, so a stream of at most
32 requests spans several windows and batches.  Every response, code and
bytes, must equal the port's ``FheApp.call`` one at a time and the JAX
package's golden ``FheApp`` (tolerance 0), in input order; the fallbacks
are counted by reason.  Then: the pooled windows on reused operands, the
checked-in fuzz corpus (``fhe_precompiles_tpu/native/fuzz_seeds``, read in
place as data), injected device faults, continuous mode.  The golden app
stands for the JAX package: its ``jax``-engine server would spend the test
clock on jit compiles.  Every wait on a future has a timeout.
"""
import collections
import dataclasses
import hashlib
import os
import sys
import threading

import numpy as np
import pytest

from fhe_precompiles_tpu import FheApp as JFheApp
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import (FheApp, PRECOMPILE_NAMES, metrics, pack,
                                       serve)
from fhe_precompiles_tpu_torch.app import _CT_CODEC
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.native import codec as codec_mod
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
from fhe_precompiles_tpu_torch.serve import (FALLBACK_REASONS, POOL_COUNTERS,
                                             ByteServer)

MAX_BATCH = 4
TIMEOUT = 60          # seconds a future may take; a hang fails at once
TYPES = ("u256", "u64", "i64", "frac64")
SCALARS = {"u256": pack.U256, "u64": pack.U64, "i64": pack.I64,
           "frac64": pack.FRAC64}
SEED_DIR = os.path.join(os.path.dirname(os.path.abspath(
    __import__("fhe_precompiles_tpu").__file__)), "native", "fuzz_seeds")


@pytest.fixture(scope="module")
def ctx():
    return BfvContext(TESTNET_ONE)


@pytest.fixture(scope="module")
def keys(ctx):
    return (ctx.generate_keys(seed=b"\x71" * 64),
            ctx.generate_keys(seed=b"\x72" * 64))


@pytest.fixture(scope="module")
def apps():
    return {"torch": FheApp(TESTNET_ONE, engine="torch", device="cpu"),
            "jax_golden": JFheApp(J_ONE)}


@pytest.fixture(scope="module")
def server(apps):
    with ByteServer(TESTNET_ONE, app=apps["torch"], max_batch=MAX_BATCH,
                    workers=4, codec="native") as s:
        yield s


def _value(tname, v):
    return float(v) if tname == "frac64" else v


def _ct(ctx, value, tname, pk, tag: bytes) -> Ciphertext:
    poly = PLAIN_TYPES[tname].encode(_value(tname, value), TESTNET_ONE)
    return ctx.encrypt(poly, pk, hashlib.sha512(tag).digest())


def _binary(pk, a, b, ca=_CT_CODEC, cb=_CT_CODEC):
    return pack.pack_binary_operation(pk, a, ca, b, cb)


@pytest.fixture(scope="module")
def mixed(ctx, keys, apps):
    """31 requests, shuffled with a numpy seed: cipher∘cipher, cipher∘plain
    and plain∘cipher of each of the four types (add, sub and mul in each
    shape, the cipher∘cipher ones under two keys and without a repeated
    operand), encrypt and decrypt of each type, reencrypt of two, the
    network key, an unknown name, truncated calldata, a multiply under a
    key without relin keys, and three size-3 ciphertexts (cipher∘cipher,
    cipher∘plain, decrypt)."""
    (pk1, _), (pk2, _) = keys
    net_pk = apps["torch"].public_key
    ops = ("add", "sub", "mul")
    reqs = []
    for j, t in enumerate(TYPES):
        pk = (pk1, pk2)[j % 2]
        a, b = (_ct(ctx, v, t, pk, b"m%d%s" % (v, t.encode()))
                for v in (6 + j, 3))
        c = f"cipher{t}"
        reqs.append((f"{ops[j % 3]}_{c}_{c}", _binary(pk, a, b)))
        reqs.append((f"{ops[(j + 1) % 3]}_{c}_{t}",
                     _binary(pk, a, _value(t, 2), cb=SCALARS[t])))
        reqs.append((f"{ops[(j + 2) % 3]}_{t}_{c}",
                     _binary(pk, _value(t, 9), b, ca=SCALARS[t])))
        reqs.append((f"encrypt_{t}", pack.pack_two_arguments(
            _value(t, 11 + j), SCALARS[t], b"pd%d" % j, pack.BYTES)))
        net_ct = _ct(ctx, 20 + j, t, net_pk, b"net" + t.encode())
        reqs.append((f"decrypt_{t}", pack.pack_one_argument(net_ct,
                                                            _CT_CODEC)))
        if j < 2:
            reqs.append((f"reencrypt_{t}", _binary(
                (pk1, pk2)[j], net_ct, b"\x02", cb=pack.BYTES)))
    # the four types' cipher∘cipher ops were add, sub, mul, add: one more
    # multiply of its own key
    a2 = _ct(ctx, 5, "u64", pk1, b"x1")
    b2 = _ct(ctx, 7, "u64", pk1, b"x2")
    reqs.append(("mul_cipheru64_cipheru64", _binary(pk1, a2, b2)))
    reqs.append(("public_key_bytes", b""))
    reqs.append(("mul_cipheru64_nope", b"\x00\x01"))
    reqs.append(("add_cipheru64_cipheru64", b"\x00\x00\x00\x08trunc"))
    reqs.append(("mul_cipheru64_cipheru64",
                 _binary(dataclasses.replace(pk1, relin=None), a2, b2)))
    c3 = ctx.multiply(a2, b2)
    reqs.append(("add_cipheru64_cipheru64", _binary(pk1, c3, a2)))
    reqs.append(("mul_cipheru64_u64", _binary(pk1, c3, 3, cb=pack.U64)))
    reqs.append(("decrypt_u64", pack.pack_one_argument(ctx.multiply(
        _ct(ctx, 2, "u64", net_pk, b"n3a"),
        _ct(ctx, 3, "u64", net_pk, b"n3b")), _CT_CODEC)))
    assert len(reqs) <= 32
    order = np.random.default_rng(11).permutation(len(reqs))
    return [reqs[i] for i in order]


@pytest.fixture(scope="module")
def expected(apps, mixed):
    return [apps["torch"].call(name, data) for name, data in mixed]


def _delta(counter, before, names):
    return {r: counter[r] - before.get(r, 0) for r in names}


@pytest.fixture
def live_refs(monkeypatch):
    """The PkRefs made while the test runs that were never released."""
    made = []
    init = codec_mod.PkRef.__init__

    def tracking_init(self, lib, handle):
        init(self, lib, handle)
        made.append(self)
    monkeypatch.setattr(codec_mod.PkRef, "__init__", tracking_init)
    return lambda: [r for r in made if r._handle]


# ---------------------------------------------------------------------------
# the mixed stream
# ---------------------------------------------------------------------------

def test_mixed_stream_equals_fheapp_call_and_the_jax_golden_app(
        server, apps, mixed, expected, live_refs):
    names = {name for name, _ in mixed}
    for t in TYPES:
        for shape in ("cipher{0}_cipher{0}", "cipher{0}_{0}", "{0}_cipher{0}"):
            assert any(n.endswith(shape.format(t)) for n in names)
    for prefix in ("add_", "sub_", "mul_", "encrypt_", "decrypt_",
                   "reencrypt_", "public_key_bytes"):
        assert any(n.startswith(prefix) for n in names)
    assert sum(name not in PRECOMPILE_NAMES for name in names) == 1
    codes = collections.Counter(code for code, _ in expected)
    assert codes[0] >= 20 and len(codes) >= 3, codes

    before = dict(server.fallbacks)
    got = server.run(mixed)
    assert len(got) == len(mixed)
    for (name, data), res, want in zip(mixed, got, expected):
        assert res == want, name
        assert res == apps["jax_golden"].call(name, data), name
    # only the three size-3 ciphertexts took the per-request path
    assert _delta(server.fallbacks, before, FALLBACK_REASONS) == {
        "not_batchable": 0, "ciphertext_size": 3, "device": 0, "encode": 0}
    assert set(server.last_split_ms) == {"decode", "device", "encode",
                                         "fallback"}
    assert not live_refs()


def test_repeated_run_is_byte_stable(server, mixed, expected):
    assert server.run(mixed[:9]) == expected[:9]
    assert server.run(mixed[:9]) == expected[:9]


# ---------------------------------------------------------------------------
# pooled windows
# ---------------------------------------------------------------------------

def test_pooled_window_on_reused_operands(ctx, keys, server, apps):
    """Six requests on two ciphertexts (squaring included) pool: each
    distinct operand goes to the device once and is prepared once."""
    pk = keys[0][0]
    a = _ct(ctx, 3, "u64", pk, b"p1")
    b = _ct(ctx, 5, "u64", pk, b"p2")
    reqs = [("mul_cipheru64_cipheru64", _binary(pk, a, b)),
            ("mul_cipheru64_cipheru64", _binary(pk, a, a)),
            ("add_cipheru64_cipheru64", _binary(pk, b, a)),
            ("sub_cipheru64_cipheru64", _binary(pk, a, b)),
            ("mul_cipheru64_cipheru64", _binary(pk, b, b)),
            ("add_cipheru64_cipheru64", _binary(pk, a, a))]
    before = dict(server.pooled)
    metrics.GLOBAL.reset()
    metrics.enable()
    try:
        got = server.run(reqs)
        snap = metrics.GLOBAL.snapshot()
    finally:
        metrics.disable()
        metrics.GLOBAL.reset()
    assert got == [apps["torch"].call(*r) for r in reqs]
    assert got[1] == apps["jax_golden"].call(*reqs[1])
    # one window (six requests <= 2 * MAX_BATCH), one key: one pooled group
    assert _delta(server.pooled, before, POOL_COUNTERS) == {
        "pooled_windows": 1, "pool_requests": 6, "pool_distinct": 2}
    assert snap["byteserver.pooled_windows"].count == 1
    assert snap["byteserver.pool_distinct"].count == 2


def test_distinct_operands_take_the_unpooled_path(ctx, keys, server, apps):
    pk = keys[1][0]
    cts = [_ct(ctx, v, "i64", pk, b"d%d" % v) for v in range(4)]
    reqs = [("mul_cipheri64_cipheri64", _binary(pk, cts[0], cts[1])),
            ("sub_cipheri64_cipheri64", _binary(pk, cts[2], cts[3]))]
    before = dict(server.pooled)
    assert server.run(reqs) == [apps["torch"].call(*r) for r in reqs]
    assert _delta(server.pooled, before, POOL_COUNTERS) == dict.fromkeys(
        POOL_COUNTERS, 0)


def test_pool_dedup_is_exact_and_survives_a_digest_collision():
    """Equal operands share a slot; operands whose digests collide never
    share one: every pair's slots hold its own operands."""
    from fhe_precompiles_tpu_torch.serve import _digest
    a = np.zeros((2, 2, 4), dtype=np.uint64)
    b = np.ones((2, 2, 4), dtype=np.uint64)
    items = [(0, "add", a, b, (_digest(a), _digest(b))),
             (1, "mul", a, a.copy(), (_digest(a), _digest(a)))]
    pool, pairs = ByteServer._pool_operands(items)
    assert len(pool) == 2 and pairs == [[0, 1], [0, 0]]
    same = (b"\x00" * 16,) * 2
    items = [(0, "add", a, b, same), (1, "add", b, a.copy(), same)]
    pool, pairs = ByteServer._pool_operands(items)
    for (_i, _op, x, y, _d), (sx, sy) in zip(items, pairs):
        assert np.array_equal(pool[sx], x) and np.array_equal(pool[sy], y)


# ---------------------------------------------------------------------------
# the fuzz corpus
# ---------------------------------------------------------------------------

def test_fuzz_seeds_give_the_golden_codes_and_bytes(server, apps):
    seeds = sorted(os.listdir(SEED_DIR))
    assert len(seeds) == 132, "fuzz corpus missing"
    reqs = []
    for fname in seeds:
        with open(os.path.join(SEED_DIR, fname), "rb") as f:
            raw = f.read()
        if raw:
            reqs.append((PRECOMPILE_NAMES[raw[0] % len(PRECOMPILE_NAMES)],
                         raw[1:]))
    got = server.run(reqs)
    for (name, data), res in zip(reqs, got):
        assert res == apps["jax_golden"].call(name, data), name
    codes = collections.Counter(code for code, _ in got)
    assert codes.get(0) and len(codes) > 2, codes


# ---------------------------------------------------------------------------
# injected device faults
# ---------------------------------------------------------------------------

# requests of the mixed stream each device call carries: the five
# size-2 cipher∘cipher ops with a relin key (no operand repeats, so no
# pool); the four encrypts and the two reencrypts' second halves; the four
# size-2 decrypts and the two reencrypts' first halves
FAULTS = {"stream.run": 5, "encrypt_batch": 6, "decrypt_batch": 6}


@pytest.mark.parametrize("target", sorted(FAULTS) + ["_prepare"])
def test_device_fault_degrades_counts_and_releases(
        ctx, keys, server, mixed, expected, monkeypatch, live_refs, target):
    """A raising device call sends its batch down the per-request path with
    the same bytes; its requests count as ``device`` and nothing else falls
    back; every key reference is released.  ``_prepare`` runs on the pooled
    path only: three squarings of one ciphertext.  The engine's batched
    calls raise only where the server makes them (called from
    ``serve.py``): the per-request path reaches the same methods from the
    engine and must still work."""
    obj = server.stream if target == "stream.run" else server.app._engine
    name = target.split(".")[-1]
    real = getattr(obj, name)

    def fail(*a, **k):
        if target.endswith("_batch") and \
                sys._getframe(1).f_code.co_filename != serve.__file__:
            return real(*a, **k)
        raise RuntimeError("injected")
    if target == "_prepare":
        pk = keys[0][0]
        a = _ct(ctx, 3, "u64", pk, b"f1")
        reqs = [("mul_cipheru64_cipheru64", _binary(pk, a, a))] * 3
        want = [server.app.call(*reqs[0])] * 3
        n_device, n_size = 3, 0
    else:
        reqs, want = mixed, expected
        n_device, n_size = FAULTS[target], 3
    monkeypatch.setattr(obj, name, fail)
    before = dict(server.fallbacks)
    assert server.run(reqs) == want
    assert _delta(server.fallbacks, before, FALLBACK_REASONS) == {
        "not_batchable": 0, "ciphertext_size": n_size, "device": n_device,
        "encode": 0}
    assert not live_refs()


def _quiesce(server) -> None:
    """Returns once every task queued on the server's worker pool before
    this call has ended: one task a worker waits on a barrier with the
    caller, and the pool takes its tasks in order."""
    barrier = threading.Barrier(server.workers + 1, timeout=TIMEOUT)
    for _ in range(server.workers):
        server._pool.submit(barrier.wait)
    barrier.wait()


@pytest.mark.parametrize("where", ["window", "decode"])
def test_a_raise_outside_the_batches_releases_every_key(
        server, mixed, expected, monkeypatch, live_refs, where):
    """A fault outside the fault-isolated batches (the first window's
    host steps, or a decode in the second window) propagates out of
    ``run``, and no key reference is left to the garbage collector: not
    the raising window's, nor those of the decode-ahead it left behind."""
    if where == "window":
        def fail(*a, **k):
            raise RuntimeError("injected")
        monkeypatch.setattr(server, "_run_window", fail)
    else:
        real = server._decode_native
        bad = mixed[2 * MAX_BATCH + 3][1]

        def fail(name, data):
            if data is bad:
                raise RuntimeError("injected")
            return real(name, data)
        monkeypatch.setattr(server, "_decode_native", fail)
    with pytest.raises(RuntimeError, match="injected"):
        server.run(mixed)
    _quiesce(server)
    assert not live_refs()
    monkeypatch.undo()
    assert server.run(mixed[:4]) == expected[:4]


# ---------------------------------------------------------------------------
# continuous mode and the constructor
# ---------------------------------------------------------------------------

def test_continuous_mode_matches_fheapp_call(server, mixed, expected):
    server.start_continuous(flush_ms=5.0)
    try:
        futs = [server.submit(name, data) for name, data in mixed]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        server.stop_continuous()
    assert got == expected


def test_native_codec_options(apps, server, mixed, expected):
    """The codec's zstd build is the python codec's by default; ``zstd``
    is refused for the python codec; a build the library refuses raises
    with its code and leaves the shared library serving as before."""
    assert server.codec.zstd_source == codec_mod.process_zstd()
    with pytest.raises(ValueError, match="zstd names the native codec"):
        ByteServer(TESTNET_ONE, app=apps["torch"], zstd="system")
    with pytest.raises(codec_mod.ZstdBuildRefused) as err:
        ByteServer(TESTNET_ONE, app=apps["torch"], codec="native",
                   zstd="/nonexistent/libzstd.so.1")
    assert err.value.code == 1
    assert server.run(mixed[:4]) == expected[:4]

"""ByteServer: batched byte-in/byte-out precompile serving on the card.

The port's counterpart of ``fhe_precompiles_tpu/serve.py``.  The
reference's surface is one calldata blob a call (bytes in, bytes out, an
error code); the card wants batches.  The server bridges the two:

  worker threads  unpack calldata
  device          the requests of a window run as batches through
                  ``RequestStream`` and ``TorchEngine``
  worker threads  pack the result ciphertexts (zstd)

Two host codecs:

* ``codec="python"``: the port's pack / keyio / zstd stack in Python (zstd
  and hashlib release the GIL).  It batches the 12 cipher∘cipher ops of
  each public key; every other request (cipher∘plain, plain∘cipher,
  encrypt, decrypt, reencrypt, public_key_bytes, a ciphertext of another
  size than 2) takes the per-request path, ``FheApp.call``.
* ``codec="native"``: the C++ codec of ``_build/libc_fhe_native.so``
  (``native/codec.py``, built from the port's copy of the sources at first
  use; a failed build raises).  Decode and encode run in C++ without the
  GIL, and the batched surface widens to all 36 binary ops (cipher∘plain
  and plain∘cipher run as batched plain ops on the card) and the threshold
  API: encrypt_* (batched seeded encrypt under the network key), decrypt_*
  (batched decrypt, the scalar decoded in C++) and reencrypt_* (batched
  network-key decrypt, C++ decode / seed / re-encode, batched encrypt
  grouped by target key).  The stream runs in windows of two batches, and
  the next window decodes while the current one computes.  A window's
  cipher∘cipher group whose operands repeat runs pooled: each distinct
  ciphertext goes to the card once and, for multiplies, is prepared once
  (``TorchEngine._prepare``).  Only ciphertexts of another size than 2
  take the per-request path.  ``zstd`` names the codec's zstd build (see
  ``NativeCodec``).

The native codec is the served path: it batches every request the card can
compute, with the same bytes, and is the faster of the two on the card
(``PERF.md`` §5, phase ``serve`` of ``chip_smoke.py``).  The python codec
stays the default only because it needs no C++ toolchain (the native one
builds with g++ at first use) and because the tests hold it independently of
the C++ codec; the default moves to ``"native"``, and the python codec
retires, once the native path has passed the soak test of identical windows
(stable bytes, no growth of resident memory).

With a ``mesh`` (``parallel.mesh``) the server's ``RequestStream`` runs
each batch of the cipher∘cipher groups over it, the batch on dp; every rank
calls ``run`` with the same requests and returns the same bytes.  That is
all a mesh changes, as in the JAX version: the native codec's pooled
windows, its plain, encrypt and decrypt batches and the per-request path
run whole on each rank's device.  A collective waits for every rank of its
group, so every path that can reach one must be the same on every rank:
the stream runs on the caller's thread in request order, requests are
grouped by a digest of their key's bytes (the same groups on every rank,
whichever thread parsed a key first), and continuous mode, whose windows
form by arrival time, is refused under a mesh.  A stream batch that fails
on any rank raises ``RankFault`` on every rank (``RequestStream``), and
the server lets it leave ``run`` on every rank instead of degrading: a
rank that degraded alone would pair its next collective with another
batch's on the other ranks, and shards of one shape mix without an error.
An error of a collective itself (``torch.distributed.DistError``) leaves
``run`` too; it may leave the world out of step, to be started again.

Otherwise a batch whose device phase raises degrades to ``FheApp.call``
request by request, with the same bytes; so does a result whose packing
raises.  Such a degrade runs on the same engine and would hide a fault of
the batched path, so every fallback is counted by its reason in
``ByteServer.fallbacks``.

Per-request outputs, payload bytes and error codes alike, equal
``FheApp.call`` one at a time.
"""
from __future__ import annotations

import collections
import hashlib
import os
import queue
import threading
import time
import types
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import convert, metrics, pack
from .app import _CT_CODEC, _PK_CODEC, FheApp, PRECOMPILE_NAMES
from .bfv.golden import Ciphertext
from .errors import FheError, FheErrorCode
from .ops.engine import TorchEngine
from .params import Params
from .parallel.mesh import Mesh, RankFault
from .parallel.stream import Request, RequestStream


class _EncPk:
    """Stands for a PublicKey that carries only its data (``encrypt_batch``
    reads ``pk.data``)."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        self.data = data


class _PkView:
    """Stands for a PublicKey that carries only its relin data
    (``RequestStream``'s contract: ``pk.relin`` is None or
    ``pk.relin.data`` is the (k, 2, k_key, n) array)."""

    class _Relin:
        __slots__ = ("data",)

        def __init__(self, data: np.ndarray):
            self.data = data

    __slots__ = ("relin",)

    def __init__(self, rk_data: Optional[np.ndarray] = None):
        self.relin = None if rk_data is None else _PkView._Relin(rk_data)

#: name -> (op, shape, tname) for the 36 binary precompiles
#: (same generation rule as app._install_ops, fhe.rs:161-576).
BINARY_SPECS = {}
for _t in ("u256", "u64", "i64", "frac64"):
    _c = f"cipher{_t}"
    for _op in ("add", "sub", "mul"):
        BINARY_SPECS[f"{_op}_{_c}_{_c}"] = (_op, "cc", _t)
        BINARY_SPECS[f"{_op}_{_c}_{_t}"] = (_op, "cp", _t)
        BINARY_SPECS[f"{_op}_{_t}_{_c}"] = (_op, "pc", _t)

#: why a request took the per-request path: the python codec does not
#: batch its op (only the 12 cipher∘cipher ops); a ciphertext of another
#: size than 2; its batch's device phase raised; a host step after the
#: device (packing its result, decoding its scalar, finishing its
#: reencrypt) raised
FALLBACK_REASONS = ("not_batchable", "ciphertext_size", "device", "encode")


def _digest(operand: np.ndarray) -> bytes:
    """The 16-byte blake2b digest of a contiguous operand's bytes."""
    return hashlib.blake2b(operand, digest_size=16).digest()


#: a stream's errors that leave ``run`` under a mesh instead of degrading
_MESH_FAULTS = (RankFault, dist.DistError)

#: ``_PK_CODEC`` giving (digest, key): requests are grouped by the digest
_KEYED_PK_CODEC = types.SimpleNamespace(
    deserialize=_PK_CODEC.deserialize_keyed)


def _pk_refs(kind: str, payload) -> list:
    """The key references (``PkRef``) one ``_decode_native`` result holds:
    each must be released once the request's window is done with it."""
    if kind == "fallback_pk":
        return [payload]
    if kind == "cc":
        return [payload[1]]
    if kind == "reenc":
        return [payload[2]]
    if kind == "plain_pk":
        return [payload[3]]
    return []


#: the pooled windows' counters (``ByteServer.pooled``, and
#: ``metrics.GLOBAL`` under ``byteserver.<name>`` while it is enabled): the
#: pooled cipher∘cipher groups, their requests, their distinct operands
POOL_COUNTERS = ("pooled_windows", "pool_requests", "pool_distinct")


class ByteServer:
    """Serve byte-level precompile requests batched on the card (or on the
    CPU, for an app whose engine the caller put there)."""

    def __init__(self, params: Params, mesh: Optional[Mesh] = None,
                 workers: Optional[int] = None, max_batch: int = 128,
                 app: Optional[FheApp] = None, codec: str = "python",
                 zstd: Optional[str] = None):
        if codec not in ("python", "native"):
            raise ValueError(f"unknown codec {codec!r}")
        if zstd is not None and codec != "native":
            raise ValueError("zstd names the native codec's zstd build; "
                             "the python codec uses serialization/"
                             "zstd_codec.py")
        self.app = app if app is not None else FheApp(
            params, engine="torch",
            device=mesh.device if mesh is not None else "cuda")
        if not isinstance(self.app._engine, TorchEngine):
            raise ValueError("ByteServer requires an FheApp(engine='torch')")
        self.params = params
        self.mesh = mesh
        self.stream = RequestStream(self.app._engine, mesh=mesh,
                                    max_batch=max_batch)
        self.workers = workers or min(32, os.cpu_count() or 1)
        self.max_batch = max_batch
        #: requests a window of the native codec: one window decodes ahead
        #: while the one before it computes and encodes
        self.pipeline_window = 2 * max_batch
        self.codec = None
        if codec == "native":
            from .native.codec import NativeCodec
            self.codec = NativeCodec(self.app, zstd=zstd)
        #: fallbacks by reason (FALLBACK_REASONS) since the server started
        self.fallbacks: Dict[str, int] = collections.Counter()
        #: POOL_COUNTERS since the server started
        self.pooled: Dict[str, int] = collections.Counter()
        #: host milliseconds of the last run's phases: decode, device,
        #: encode, fallback.  With the native codec, decode is the time the
        #: run waited for a window's decode (the rest overlaps the device),
        #: and each phase is summed over the windows.
        self.last_split_ms: Dict[str, float] = {}
        self._lock = threading.Lock()
        # one worker pool for the server's lifetime, not one a run
        self._pool = ThreadPoolExecutor(max_workers=self.workers)
        self._cthread: Optional[threading.Thread] = None

    def close(self) -> None:
        """Stop the continuous loop (if running) and the worker pool
        (idempotent)."""
        self.stop_continuous()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # continuous (queue-fed) serving: the per-call latency surface
    # ------------------------------------------------------------------
    def start_continuous(self, flush_ms: float = 5.0,
                         max_window: Optional[int] = None) -> None:
        """Start the queue-fed serving loop.

        A window flushes when it holds ``max_window`` requests or
        ``flush_ms`` milliseconds after its first request arrived, whichever
        comes first (``max_window`` defaults to two batches): an idle
        server answers a lone request within about flush_ms and one
        request's compute, a loaded one runs full windows back to back."""
        if self.mesh is not None:
            raise ValueError("continuous mode forms its windows by arrival "
                             "time, which differs between ranks; over a "
                             "mesh every rank must run the same batches")
        with self._lock:
            if self._cthread is not None:
                raise RuntimeError("continuous mode already running")
            self._cq: "queue.Queue" = queue.Queue()
            self._cstop = threading.Event()
            self._cthread = threading.Thread(
                target=self._continuous_loop,
                args=(self._cq, self._cstop, flush_ms / 1000.0,
                      max_window or self.pipeline_window),
                name="byteserver-continuous", daemon=True)
            self._cthread.start()

    def submit(self, name: str, data: bytes) -> Future:
        """Enqueue one request; returns a Future of (code, payload_bytes)
        equal to ``FheApp.call(name, data)``."""
        fut: Future = Future()
        with self._lock:
            if self._cthread is None:
                raise RuntimeError("call start_continuous() first")
            self._cq.put((name, data, fut))
        return fut

    def stop_continuous(self) -> None:
        """Stop the loop after it has answered every queued request
        (idempotent)."""
        with self._lock:
            t, self._cthread = self._cthread, None
            if t is None:
                return
            stop = self._cstop
        # no submit can enqueue now: the loop drains what is queued, then ends
        stop.set()
        t.join()

    def _continuous_loop(self, q: "queue.Queue", stop: threading.Event,
                         flush_s: float, max_window: int) -> None:
        while True:
            try:
                item = q.get(timeout=0.02)
            except queue.Empty:
                if stop.is_set():
                    return
                continue
            window = [item]
            deadline = time.monotonic() + flush_s
            while len(window) < max_window:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    window.append(q.get(timeout=remaining))
                except queue.Empty:
                    break
            # a future cancelled while queued is dropped here; the others
            # can no longer be cancelled, so setting their result cannot fail
            live = [(name, data, f) for name, data, f in window
                    if f.set_running_or_notify_cancel()]
            if not live:
                continue
            try:
                outs = self.run([(name, data) for name, data, _f in live])
            except Exception as exc:  # run() degrades device faults itself;
                # this is a fault of the server: every future carries it
                for _n, _d, f in live:
                    f.set_exception(exc)
                continue
            for (_n, _d, f), out in zip(live, outs):
                f.set_result(out)

    # ------------------------------------------------------------------
    def _decode_cc(self, name: str, data: bytes):
        """``FheApp._binary_op``'s decode and checks for a cipher∘cipher
        op (same codecs, same order, same error codes): (op, key, pk, a,
        b), `key` the SHA-256 of the key's bytes, or raises FheError."""
        op, shape, _tname = BINARY_SPECS[name]
        if shape != "cc":
            raise ValueError(f"{name} is not a cipher∘cipher op")
        (key, pk), a, b = pack.unpack_binary_operation(
            data, _KEYED_PK_CODEC, _CT_CODEC, _CT_CODEC)
        self.app._check_params(pk, FheErrorCode.RUNTIME_ERROR)
        self.app._check_params(a, FheErrorCode.RUNTIME_ERROR)
        self.app._check_params(b, FheErrorCode.RUNTIME_ERROR)
        if op == "mul" and pk.relin is None:
            raise FheError(FheErrorCode.RUNTIME_ERROR,
                           "public key lacks relinearization keys")
        if op == "mul" and pk.relin.params != self.params:
            # FheApp._run_op's guard on the relin key's parameter set
            raise FheError(FheErrorCode.RUNTIME_ERROR,
                           "relin key parameter set mismatch")
        return op, key, pk, a, b

    def _count(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.fallbacks[reason] += n

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Tuple[str, bytes]]
            ) -> List[Tuple[int, bytes]]:
        """Execute a mixed byte-request stream; returns per-request
        (error_code, payload) in input order, byte-equal to FheApp.call.

        With ``metrics.enable()``, per-op counts, bytes and errors are
        recorded, the batch's wall time shared out by each op's count."""
        run = self._run_native if self.codec is not None else \
            self._run_python
        if not metrics.GLOBAL.enabled:
            return run(requests)
        t0 = time.perf_counter()
        results = run(requests)
        dt = time.perf_counter() - t0
        per_op: dict = {}
        for (name, data), (code, payload) in zip(requests, results):
            c, e, bi, bo = per_op.get(name, (0, 0, 0, 0))
            per_op[name] = (c + 1, e + (1 if code else 0),
                            bi + len(data), bo + len(payload))
        total = max(1, len(requests))
        for name, (c, e, bi, bo) in per_op.items():
            metrics.GLOBAL.record_batch(name, c, dt * c / total, bi, bo, e)
        return results

    def _run_python(self, requests: Sequence[Tuple[str, bytes]]
                    ) -> List[Tuple[int, bytes]]:
        k, n = len(self.params.ct_moduli), self.params.n
        results: List[Optional[Tuple[int, bytes]]] = [None] * len(requests)
        # (idx, op, a, b) of the batchable requests, keyed by the digest
        # of their key's bytes
        groups: Dict[bytes, list] = {}
        pk_by_key: Dict[bytes, object] = {}
        fallback: List[int] = []
        t0 = time.perf_counter()

        def decode(i: int):
            name, data = requests[i]
            if name not in PRECOMPILE_NAMES:
                return i, "err", int(FheErrorCode.INVALID_ENCODING)
            spec = BINARY_SPECS.get(name)
            if spec is None or spec[1] != "cc":
                return i, "not_batchable", None
            try:
                op, key, pk, a, b = self._decode_cc(name, data)
            except FheError as e:
                return i, "err", int(e.code)
            except Exception:
                return i, "err", int(FheErrorCode.RUNTIME_ERROR)
            # only size-2 ciphertexts stack into one batch
            if a.data.shape != (2, k, n) or b.data.shape != a.data.shape:
                return i, "ciphertext_size", None
            return i, "batch", (op, key, pk, a, b)

        for i, kind, payload in self._pool.map(decode, range(len(requests))):
            if kind == "err":
                results[i] = (payload, b"")
            elif kind == "batch":
                op, key, pk, a, b = payload
                groups.setdefault(key, []).append((i, op, a, b))
                pk_by_key.setdefault(key, pk)
            else:
                fallback.append(i)
                self._count(kind)
        t1 = time.perf_counter()

        # device phase: one RequestStream.run a public key; a group that
        # raises degrades to the per-request path (on a mesh: see above)
        encode_jobs: List[Tuple[int, np.ndarray]] = []
        for key, items in groups.items():
            try:
                outs = self.stream.run(
                    [Request(op, a.data, b.data) for _, op, a, b in items],
                    pk_by_key[key])
            except _MESH_FAULTS:
                raise
            except Exception:
                fallback.extend(i for i, *_ in items)
                self._count("device", len(items))
                continue
            encode_jobs.extend((i, out) for (i, *_), out in zip(items, outs))
        t2 = time.perf_counter()

        def encode(job):
            i, data = job
            try:
                return i, Ciphertext(self.params, data).to_bytes()
            except Exception:
                return i, None

        for i, payload in self._pool.map(encode, encode_jobs):
            if payload is None:
                fallback.append(i)
                self._count("encode")
            else:
                results[i] = (0, payload)
        t3 = time.perf_counter()

        # the per-request path, in the caller's thread
        for i in fallback:
            results[i] = self.app.call(*requests[i])
        t4 = time.perf_counter()
        self.last_split_ms = {
            "decode": (t1 - t0) * 1e3, "device": (t2 - t1) * 1e3,
            "encode": (t3 - t2) * 1e3, "fallback": (t4 - t3) * 1e3}
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # the native codec
    # ------------------------------------------------------------------
    def _run_cc_pooled(self, items, pairs, pool_list, rk_data):
        """A window's cipher∘cipher group of one key, with its operands
        pooled: each distinct ciphertext goes to the card once and, where
        the group multiplies, is prepared once (``TorchEngine._prepare``,
        the Bsk lift and forward transforms, in chunks of ``max_batch``
        pool rows); requests gather their operands from the pool, one
        dispatch a chunk of ``max_batch`` requests of one op.

        items: [(request index, op, a, b, digests)]; pairs[j]: the pool
        slots of item j's operands; pool_list: the distinct (2, k, n)
        operands.
        Returns the (2, k, n) results in item order, equal to the unpooled
        path's."""
        eng = self.app._engine
        dev, cb = eng.device, self.max_batch
        pool_raw = convert.ciphertexts_from_numpy(np.stack(pool_list), dev)
        order: Dict[str, List[int]] = {}
        for j, (_i, op, *_) in enumerate(items):
            order.setdefault(op, []).append(j)
        pool_prep = rk = None
        if "mul" in order:
            rk = convert.relin_keys_from_numpy(rk_data, dev)
            parts = [eng._prepare(pool_raw[p0:p0 + cb])
                     for p0 in range(0, len(pool_list), cb)]
            pool_prep = parts[0] if len(parts) == 1 else torch.cat(parts)
        slots = torch.as_tensor(np.asarray(pairs, dtype=np.int64),
                                device=dev)
        results: List[Optional[np.ndarray]] = [None] * len(items)
        for op, idxs in order.items():
            src = pool_prep if op == "mul" else pool_raw
            for c0 in range(0, len(idxs), cb):
                chunk = idxs[c0:c0 + cb]
                rows = slots[chunk]
                a = src.index_select(0, rows[:, 0])
                b = src.index_select(0, rows[:, 1])
                if op == "mul":
                    out = eng._mul_relin_prepared(a, b, rk)
                elif op == "add":
                    out = eng._add(a, b)
                else:
                    out = eng._sub(a, b)
                host = convert.to_numpy(out)
                for s, j in enumerate(chunk):
                    results[j] = host[s]
        return results

    def _decode_native(self, name: str, data: bytes):
        """One request through the C++ codec: (kind, payload), the kind
        saying where it goes."""
        cod = self.codec
        if name not in PRECOMPILE_NAMES:
            return "err", int(FheErrorCode.INVALID_ENCODING)
        if name == "public_key_bytes":
            return "done", (0, self.app.public_key_bytes())
        head, _, rest = name.partition("_")
        if head == "encrypt":
            code, m, seed = cod.unpack_encrypt(rest, data)
            return ("err", code) if code else ("enc", (m, seed))
        if head == "decrypt":
            code, ct, size = cod.unpack_decrypt(data)
            if code:
                return "err", code
            if size != 2:
                return "fallback", None
            return "dec", (rest, ct)
        if head == "reencrypt":
            code, ct, size, pk = cod.unpack_reencrypt(data)
            if code:
                return "err", code
            if size != 2:
                return "fallback_pk", pk
            return "reenc", (rest, ct, pk)
        code, shape, op, ct, other, ct_size, other_size, pk = \
            cod.unpack_binary(name, data)
        if code:
            return "err", code
        if shape == "cc":
            if ct_size != 2 or other_size != 2:
                return "fallback_pk", pk
            # the operands' digests for the window's pool, taken here on
            # the worker thread (hashlib releases the GIL)
            return "cc", (op, pk, ct, other,
                          (_digest(ct), _digest(other)))
        # cipher∘plain and plain∘cipher never touch the key
        if ct_size != 2:
            return "fallback_pk", pk
        if op == "add":
            fn = "add_plain"
        elif op == "mul":
            fn = "mul_plain"
        else:
            fn = "sub_plain" if shape == "cp" else "plain_sub"
        return "plain_pk", (fn, ct, other, pk)

    @staticmethod
    def _pool_operands(items):
        """Dedup a group's operands by their blake2b digests (``_digest``,
        taken at decode) and exact bytes (a digest collision never computes
        with the wrong operand): the distinct operands and each item's pair
        of slots."""
        pool_list: List[np.ndarray] = []
        pool_idx: Dict[bytes, int] = {}
        pairs = []
        for _i, _op, a, b, digests in items:
            pair = []
            for operand, h in zip((a, b), digests):
                slot = pool_idx.get(h)
                if slot is not None and not np.array_equal(pool_list[slot],
                                                           operand):
                    slot = None         # a collision: a new entry
                if slot is None:
                    slot = len(pool_list)
                    pool_idx[h] = slot
                    pool_list.append(operand)
                pair.append(slot)
            pairs.append(pair)
        return pool_list, pairs

    def _count_pooled(self, requests: int, distinct: int) -> None:
        with self._lock:
            self.pooled["pooled_windows"] += 1
            self.pooled["pool_requests"] += requests
            self.pooled["pool_distinct"] += distinct
        metrics.GLOBAL.record_batch("byteserver.pooled_windows", 1)
        metrics.GLOBAL.record_batch("byteserver.pool_requests", requests)
        metrics.GLOBAL.record_batch("byteserver.pool_distinct", distinct)

    def _run_native(self, requests: Sequence[Tuple[str, bytes]]
                    ) -> List[Tuple[int, bytes]]:
        """The native codec's path: C++ decode and encode in the worker
        threads, the device compute batched by op family, in windows of
        ``pipeline_window`` requests; window w + 1 decodes while window w
        computes and encodes.  Every key reference a decode made is
        released before this returns or raises."""
        n_req = len(requests)
        results: List[Optional[Tuple[int, bytes]]] = [None] * n_req
        fallback: List[int] = []
        split = dict.fromkeys(("decode", "device", "encode", "fallback"), 0.0)
        W = self.pipeline_window
        windows = [range(w0, min(w0 + W, n_req)) for w0 in range(0, n_req, W)]
        submitted: List[Future] = []    # every decode of the run

        def decode_window(w: int) -> List[Future]:
            def decode(i: int):
                return (i,) + self._decode_native(*requests[i])
            futs = [self._pool.submit(decode, i) for i in windows[w]]
            submitted.extend(futs)
            return futs

        try:
            futs = decode_window(0) if windows else []
            for w in range(len(windows)):
                t0 = time.perf_counter()
                decoded = [f.result() for f in futs]
                if w + 1 < len(windows):  # decode-ahead: overlaps the window
                    futs = decode_window(w + 1)
                split["decode"] += (time.perf_counter() - t0) * 1e3
                try:
                    self._run_window(requests, decoded, results, fallback,
                                     split)
                finally:
                    for _i, kind, payload in decoded:
                        for pk in _pk_refs(kind, payload):
                            pk.release()
        finally:
            # the decodes a raise left behind; the windows' own finally
            # has released the rest already (release is idempotent)
            for f in submitted:
                if f.cancel():
                    continue
                try:
                    _i, kind, payload = f.result()
                except Exception:
                    continue
                for pk in _pk_refs(kind, payload):
                    pk.release()

        # the per-request path, in the caller's thread
        t3 = time.perf_counter()
        for i in fallback:
            results[i] = self.app.call(*requests[i])
        split["fallback"] = (time.perf_counter() - t3) * 1e3
        self.last_split_ms = split
        return results  # type: ignore[return-value]

    def _run_window(self, requests, decoded, results, fallback, split
                    ) -> None:
        """One window of ``_run_native``: its decoded requests sorted by
        where they go, the device batches (each fault-isolated: a raising
        batch sends its requests to ``fallback``), then the encodes.
        Fills ``results``, ``fallback`` and the device and encode parts of
        ``split``."""
        cod, app = self.codec, self.app
        eng = app._engine
        dev, cb = eng.device, self.max_batch
        pool = self._pool
        t1 = time.perf_counter()
        cc_groups: Dict[bytes, list] = {}
        pk_by_key: Dict[bytes, object] = {}
        plain_jobs: Dict[str, list] = {}
        enc_jobs, dec_jobs, reenc_jobs = [], [], []
        for i, kind, payload in decoded:
            if kind == "err":
                results[i] = (payload, b"")
            elif kind == "done":
                results[i] = payload
            elif kind in ("fallback", "fallback_pk"):
                fallback.append(i)
                self._count("ciphertext_size")
            elif kind == "enc":
                enc_jobs.append((i,) + payload)
            elif kind == "dec":
                dec_jobs.append((i,) + payload)
            elif kind == "reenc":
                reenc_jobs.append((i,) + payload)
            elif kind == "plain_pk":
                fn, ct, other, _pk = payload
                plain_jobs.setdefault(fn, []).append((i, ct, other))
            else:  # cc
                op, pk, a, b, digests = payload
                cc_groups.setdefault(pk.digest, []).append(
                    (i, op, a, b, digests))
                pk_by_key.setdefault(pk.digest, pk)

        # ---- device phase: every batch is fault-isolated -----------------
        encode_jobs: List[Tuple[int, np.ndarray]] = []
        dec_polys: List[Tuple[int, str, np.ndarray]] = []

        def guarded(idxs, fn):
            try:
                fn()
            except _MESH_FAULTS:
                raise
            except Exception:
                fallback.extend(idxs)
                self._count("device", len(idxs))

        for key, items in cc_groups.items():
            def do_cc(items=items, pk=pk_by_key[key]):
                rk_data = (pk.relin(cod.k, cod.kk, cod.n)
                           if any(it[1] == "mul" for it in items) else None)
                pool_list, pairs = self._pool_operands(items)
                if len(pool_list) < 2 * len(items):
                    self._count_pooled(len(items), len(pool_list))
                    outs = self._run_cc_pooled(items, pairs, pool_list,
                                               rk_data)
                else:   # no operand repeats: the plain batches
                    outs = self.stream.run(
                        [Request(op, a, b) for _, op, a, b, _ in items],
                        _PkView(rk_data))
                encode_jobs.extend(
                    (i, out) for (i, *_), out in zip(items, outs))
            guarded([i for i, *_ in items], do_cc)

        # cipher∘plain and plain∘cipher: batched plain ops
        for fn, items in plain_jobs.items():
            dev_fn = getattr(eng, "_" + fn)
            for c0 in range(0, len(items), cb):
                chunk = items[c0:c0 + cb]

                def do_plain(chunk=chunk, fn=fn, dev_fn=dev_fn):
                    cts = convert.ciphertexts_from_numpy(
                        np.stack([c for _, c, _ in chunk]), dev)
                    ms = convert.plaintexts_from_numpy(
                        np.stack([m for _, _, m in chunk]), dev)
                    out = (dev_fn(ms, cts) if fn == "plain_sub"
                           else dev_fn(cts, ms))
                    host = convert.to_numpy(out)
                    encode_jobs.extend(
                        (i, host[s]) for s, (i, _c, _m) in enumerate(chunk))
                guarded([i for i, *_ in chunk], do_plain)

        # threshold encrypt: batched seeded encrypt, network key
        for c0 in range(0, len(enc_jobs), cb):
            chunk = enc_jobs[c0:c0 + cb]

            def do_enc(chunk=chunk):
                host = convert.to_numpy(eng.encrypt_batch(
                    np.stack([m for _, m, _ in chunk]), app.public_key,
                    [s for _, _, s in chunk]))
                encode_jobs.extend(
                    (i, host[s]) for s, (i, _m, _s) in enumerate(chunk))
            guarded([i for i, *_ in chunk], do_enc)

        # threshold decrypt: batched decrypt, the scalar in C++
        for c0 in range(0, len(dec_jobs), cb):
            chunk = dec_jobs[c0:c0 + cb]

            def do_dec(chunk=chunk):
                host = convert.to_numpy(eng.decrypt_batch(
                    convert.ciphertexts_from_numpy(
                        np.stack([c for _, _, c in chunk]), dev),
                    app.private_key))
                dec_polys.extend(
                    (i, tname, host[s]) for s, (i, tname, _c)
                    in enumerate(chunk))
            guarded([i for i, *_ in chunk], do_dec)

        # reencrypt: batched network-key decrypt, C++ decode / seed /
        # re-encode, then batched encrypt a target key
        if reenc_jobs:
            polys: Dict[int, np.ndarray] = {}
            for c0 in range(0, len(reenc_jobs), cb):
                chunk = reenc_jobs[c0:c0 + cb]

                def do_rdec(chunk=chunk, c0=c0):
                    host = convert.to_numpy(eng.decrypt_batch(
                        convert.ciphertexts_from_numpy(
                            np.stack([c for _, _, c, _ in chunk]), dev),
                        app.private_key))
                    for s in range(len(chunk)):
                        polys[c0 + s] = host[s]
                guarded([i for i, *_ in chunk], do_rdec)

            def finish(idx):
                i, tname, _ct, _pk = reenc_jobs[idx]
                try:
                    return idx, cod.reencrypt_finish(
                        tname, requests[i][1], polys[idx])
                except Exception:
                    return idx, None

            re_groups: Dict[bytes, list] = {}
            for idx, out in pool.map(finish, sorted(polys)):
                i, _t, _c, pk = reenc_jobs[idx]
                if out is None:
                    fallback.append(i)
                    self._count("encode")
                elif out[0]:
                    results[i] = (out[0], b"")
                else:
                    re_groups.setdefault(pk.digest, []).append(
                        (i, out[1], out[2], pk))
            for items in re_groups.values():
                for c0 in range(0, len(items), cb):
                    chunk = items[c0:c0 + cb]

                    def do_renc(chunk=chunk, pk=items[0][3]):
                        host = convert.to_numpy(eng.encrypt_batch(
                            np.stack([m for _, m, _, _ in chunk]),
                            _EncPk(pk.data(cod.kk, cod.n)),
                            [s for _, _, s, _ in chunk]))
                        encode_jobs.extend(
                            (i, host[s]) for s, (i, *_) in enumerate(chunk))
                    guarded([i for i, *_ in chunk], do_renc)
        t2 = time.perf_counter()
        split["device"] += (t2 - t1) * 1e3

        # ---- host encode (C++ zstd / bincode, GIL-free) ------------------
        def encode(job):
            i, data = job
            try:
                return i, (0, cod.pack_ciphertext(data))
            except Exception:
                return i, None

        def decode_scalar(job):
            i, tname, poly = job
            try:
                return i, cod.decode_scalar(tname, poly)
            except Exception:
                return i, None

        for job_fn, jobs in ((encode, encode_jobs),
                             (decode_scalar, dec_polys)):
            for i, payload in pool.map(job_fn, jobs):
                if payload is None:
                    fallback.append(i)
                    self._count("encode")
                else:
                    results[i] = payload
        split["encode"] += (time.perf_counter() - t2) * 1e3

"""ByteServer: batched byte-in/byte-out precompile serving on the card.

The port's counterpart of ``fhe_precompiles_tpu/serve.py`` with its python
codec.  The reference's surface is one calldata blob a call (bytes in,
bytes out, an error code); the card wants batches.  The server bridges the
two:

  worker threads  unpack calldata (zstd and hashlib release the GIL)
  device          the 12 cipher∘cipher ops of each public key run as
                  batches through ``RequestStream`` and ``TorchEngine``
  worker threads  pack the result ciphertexts (zstd)

Every other request (cipher∘plain, plain∘cipher, encrypt, decrypt,
reencrypt, public_key_bytes, a ciphertext of another size than 2) takes the
per-request path, ``FheApp.call``.  So is a group whose device phase
raises: it degrades to ``FheApp.call`` request by request, with the same
bytes.  Such a degrade runs on the same engine and would hide a fault of
the batched path, so every fallback is counted by its reason in
``ByteServer.fallbacks``.

Per-request outputs, payload bytes and error codes alike, equal
``FheApp.call`` one at a time.

The JAX package's native codec (``codec="native"``, a C++ codec in
``libc_fhe_native.so``) and its pooled windows are not ported yet.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import metrics, pack
from .app import _CT_CODEC, _PK_CODEC, FheApp, PRECOMPILE_NAMES
from .bfv.golden import Ciphertext
from .errors import FheError, FheErrorCode
from .ops.engine import TorchEngine
from .params import Params
from .parallel.stream import Request, RequestStream

#: name -> (op, shape, tname) for the 36 binary precompiles
#: (same generation rule as app._install_ops, fhe.rs:161-576).
BINARY_SPECS = {}
for _t in ("u256", "u64", "i64", "frac64"):
    _c = f"cipher{_t}"
    for _op in ("add", "sub", "mul"):
        BINARY_SPECS[f"{_op}_{_c}_{_c}"] = (_op, "cc", _t)
        BINARY_SPECS[f"{_op}_{_c}_{_t}"] = (_op, "cp", _t)
        BINARY_SPECS[f"{_op}_{_t}_{_c}"] = (_op, "pc", _t)

#: why a request took the per-request path: not one of the 12 cipher∘cipher
#: ops; a ciphertext of another size than 2; its group's device phase
#: raised; packing its result raised
FALLBACK_REASONS = ("not_batchable", "ciphertext_size", "device", "encode")


class ByteServer:
    """Serve byte-level precompile requests batched on the card (or on the
    CPU, for an app whose engine the caller put there)."""

    def __init__(self, params: Params, workers: Optional[int] = None,
                 max_batch: int = 128, app: Optional[FheApp] = None,
                 codec: str = "python"):
        if codec == "native":
            raise ValueError(
                "codec='native' is not ported yet (ROADMAP.md queue 1 item "
                "6: the native codec and its pooled windows)")
        if codec != "python":
            raise ValueError(f"unknown codec {codec!r}")
        self.app = app if app is not None else FheApp(params, engine="torch")
        if not isinstance(self.app._engine, TorchEngine):
            raise ValueError("ByteServer requires an FheApp(engine='torch')")
        self.params = params
        self.stream = RequestStream(self.app._engine, max_batch=max_batch)
        self.workers = workers or min(32, os.cpu_count() or 1)
        self.max_batch = max_batch
        #: fallbacks by reason (FALLBACK_REASONS) since the server started
        self.fallbacks: Dict[str, int] = collections.Counter()
        #: host milliseconds of the last run's phases: decode, device,
        #: encode, fallback
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
        with self._lock:
            if self._cthread is not None:
                raise RuntimeError("continuous mode already running")
            self._cq: "queue.Queue" = queue.Queue()
            self._cstop = threading.Event()
            self._cthread = threading.Thread(
                target=self._continuous_loop,
                args=(self._cq, self._cstop, flush_ms / 1000.0,
                      max_window or 2 * self.max_batch),
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
        op (same codecs, same order, same error codes): (op, pk, a, b) or
        raises FheError."""
        op, shape, _tname = BINARY_SPECS[name]
        if shape != "cc":
            raise ValueError(f"{name} is not a cipher∘cipher op")
        pk, a, b = pack.unpack_binary_operation(
            data, _PK_CODEC, _CT_CODEC, _CT_CODEC)
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
        return op, pk, a, b

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
        if not metrics.GLOBAL.enabled:
            return self._run_python(requests)
        t0 = time.perf_counter()
        results = self._run_python(requests)
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
        # (idx, op, a, b) of the batchable requests, keyed by pk identity:
        # the pk cache hands out one object for each distinct key's bytes
        groups: Dict[int, list] = {}
        pk_by_id: Dict[int, object] = {}
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
                op, pk, a, b = self._decode_cc(name, data)
            except FheError as e:
                return i, "err", int(e.code)
            except Exception:
                return i, "err", int(FheErrorCode.RUNTIME_ERROR)
            # only size-2 ciphertexts stack into one batch
            if a.data.shape != (2, k, n) or b.data.shape != a.data.shape:
                return i, "ciphertext_size", None
            return i, "batch", (op, pk, a, b)

        for i, kind, payload in self._pool.map(decode, range(len(requests))):
            if kind == "err":
                results[i] = (payload, b"")
            elif kind == "batch":
                op, pk, a, b = payload
                groups.setdefault(id(pk), []).append((i, op, a, b))
                pk_by_id[id(pk)] = pk
            else:
                fallback.append(i)
                self._count(kind)
        t1 = time.perf_counter()

        # device phase: one RequestStream.run a public key; a group that
        # raises degrades to the per-request path
        encode_jobs: List[Tuple[int, np.ndarray]] = []
        for key, items in groups.items():
            try:
                outs = self.stream.run(
                    [Request(op, a.data, b.data) for _, op, a, b in items],
                    pk_by_id[key])
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

"""Per-op metrics: counters, latency, throughput, noise-budget observability.

The port's own copy of ``fhe_precompiles_tpu/metrics.py``.  The reference has
no observability at all; this module provides structured per-op metrics
(ops/sec, bytes in/out, error counts) with zero overhead when disabled.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


@dataclasses.dataclass
class OpStats:
    count: int = 0
    errors: int = 0
    total_seconds: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0

    @property
    def ops_per_sec(self) -> float:
        return self.count / self.total_seconds if self.total_seconds else 0.0


class MetricsRegistry:
    """Thread-safe per-op stats registry."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: Dict[str, OpStats] = defaultdict(OpStats)

    @contextlib.contextmanager
    def measure(self, op: str, bytes_in: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        except Exception:
            with self._lock:
                s = self._stats[op]
                s.errors += 1
                s.total_seconds += time.perf_counter() - t0
            raise
        with self._lock:
            s = self._stats[op]
            s.count += 1
            s.bytes_in += bytes_in
            s.total_seconds += time.perf_counter() - t0

    def record_output(self, op: str, nbytes: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._stats[op].bytes_out += nbytes

    def record_batch(self, op: str, count: int, seconds: float = 0.0,
                     bytes_in: int = 0, bytes_out: int = 0,
                     errors: int = 0) -> None:
        """Bulk accounting for batched execution paths (ByteServer):
        `seconds` is the wall time attributed to this op's share of the
        batch, so ops_per_sec stays meaningful across surfaces."""
        if not self.enabled:
            return
        with self._lock:
            s = self._stats[op]
            s.count += count
            s.errors += errors
            s.total_seconds += seconds
            s.bytes_in += bytes_in
            s.bytes_out += bytes_out

    def snapshot(self) -> Dict[str, OpStats]:
        with self._lock:
            return {k: dataclasses.replace(v) for k, v in self._stats.items()}

    def report_json(self) -> str:
        return json.dumps({
            op: {"count": s.count, "errors": s.errors,
                 "ops_per_sec": round(s.ops_per_sec, 2),
                 "mean_ms": round(1e3 * s.total_seconds / s.count, 3)
                 if s.count else None,
                 "bytes_in": s.bytes_in, "bytes_out": s.bytes_out}
            for op, s in sorted(self.snapshot().items())})

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: Process-global registry used by FheApp.call (opt-in via enable()).
GLOBAL = MetricsRegistry(enabled=False)


def enable() -> None:
    GLOBAL.enabled = True


def disable() -> None:
    GLOBAL.enabled = False

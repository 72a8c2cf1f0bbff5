"""What a ``--trace 1`` run reads from ``torch.profiler``, reduced to plain
lists, and the reductions every per-layer reader shares.

The harness traces a short window of whole blocks under one
``record_function`` range (``WINDOW``), each block under another
(``BLOCK``).  From the profiler's events it keeps the device operations
(kernels, copies, sets) and the host operations of the thread that issued
the blocks, in seconds on the profiler's clock.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "bench_port.traced_window"
BLOCK = "bench_port.block"
TOP = 10
# host calls in which the issuing thread waits for the card
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


@dataclasses.dataclass
class Op:
    name: str
    start: float                # seconds
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    device_ops: List[Op]        # inside the window, clipped to it
    host_ops: List[Op]          # of the issuing thread
    start: float
    end: float
    blocks: int                 # whole blocks inside the window

    @property
    def window_s(self) -> float:
        return self.end - self.start


def from_profiler(prof, blocks: int) -> Trace:
    """The trace of a ``torch.profiler.profile`` over the window."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW
              and e.device_type == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} windows, not 1")
    w = window[0]
    start, end = w.time_range.start / 1e6, w.time_range.end / 1e6
    device, host = [], []
    for e in events:
        op = Op(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("bench_port."):
                continue
            if op.end > start and op.start < end:
                device.append(Op(op.name, max(op.start, start),
                                 min(op.end, end)))
        elif e.thread == w.thread:
            host.append(op)
    return Trace(device, host, start, end, blocks)


def busy_intervals(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, as sorted disjoint pairs."""
    out: List[List[float]] = []
    for s, e in sorted((o.start, o.end) for o in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr.device_ops))


def block_issue_seconds(tr: Trace) -> List[float]:
    """For each traced block, its host span minus the time the issuing
    thread spent inside it waiting for the card (``WAITS``)."""
    blocks = sorted((o for o in tr.host_ops if o.name == BLOCK),
                    key=lambda o: o.start)
    waits = sorted((o for o in tr.host_ops if o.name in WAITS),
                   key=lambda o: o.start)
    out, w = [], 0
    for b in blocks:
        while w < len(waits) and waits[w].start < b.start:
            w += 1
        waited = 0.0
        while w < len(waits) and waits[w].start < b.end:
            waited += min(waits[w].end, b.end) - waits[w].start
            w += 1
        out.append(b.seconds - waited)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)", "{anon}")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0]


def device_op_seconds(tr: Trace) -> List[Tuple[str, float]]:
    """Device seconds by operation, most first."""
    by: Dict[str, float] = defaultdict(float)
    for o in tr.device_ops:
        by[short_name(o.name)] += o.seconds
    return sorted(by.items(), key=lambda kv: -kv[1])


def idle_gaps(tr: Trace) -> List[Tuple[str, float]]:
    """Idle device seconds by what the issuing thread was doing at each
    gap's middle: its innermost host operation there, under the one that
    holds it; most first."""
    gaps, t = [], tr.start
    for s, e in busy_intervals(tr.device_ops):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.end > t:
        gaps.append((t, tr.end))
    host = sorted(tr.host_ops, key=lambda o: (o.start, -o.end))
    by: Dict[str, float] = defaultdict(float)
    stack: List[Op] = []
    h = 0
    for s, e in gaps:
        mid = (s + e) / 2
        while h < len(host) and host[h].start <= mid:
            while stack and stack[-1].end < host[h].start:
                stack.pop()
            stack.append(host[h])
            h += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        names = [o.name for o in stack
                 if o.name not in (WINDOW, BLOCK)][-2:]
        if not names:
            label = ("the stream's Python between calls"
                     if any(o.name == BLOCK for o in stack)
                     else "the harness between blocks")
        else:
            label = " > ".join(names)
        by[label] += e - s
    return sorted(by.items(), key=lambda kv: -kv[1])


def breakdown(tr: Trace) -> dict:
    return {"device_ops": [[n, s] for n, s in device_op_seconds(tr)[:TOP]],
            "idle_gaps": [[n, s] for n, s in idle_gaps(tr)[:TOP]]}

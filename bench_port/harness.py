"""One run of one cell: set-up, the measured window, the traced window, and
the comparison that decides ``correct``.

The window drives ``RequestStream(TorchEngine(params, device), max_batch).
run_pooled_fused(ops, idx_pairs, pool, pk)`` of ``fhe_precompiles_tpu_torch``:
one call is one block of requests on the pool of ciphertexts that set-up put
on the card, and it returns after the stream's own synchronize.  Blocks are
issued back to back, one in flight, until ``seconds`` have passed; the last
one started runs to its end and the window with it.

A mix with plain ops (``traffic.PLAIN_OPS``) is driven as
``run_pooled_fused(ops, idx_pairs, pool, pk, plains=plain_pool)``, where
``plain_pool`` is the (P_plain, n) int64 tensor of plaintexts on the card
and, for a plain op, ``idx_pairs[r, 0]`` indexes ``pool`` and
``idx_pairs[r, 1]`` ``plain_pool``; ``plain_sub`` is plaintext minus
ciphertext.  A mix without plain ops is driven with the four arguments
alone.  Either way the call returns
``{op: (request indices, (m, 2, k, n) int64 tensor of results)}``.

Set-up (timed from the process's start, so loading counts) makes the keys,
the fresh encryptions, the pool and any plaintext pool from the seed, builds
the engine (which compiles the port's kernel library in the checkout on a
first run) and runs ``HELD_BLOCKS + 1`` blocks of the cell's own shapes
while holding their outputs, so that the allocator has what the window
needs.  Every block of a cell has the same counts of each op, so one block
covers every shape.

While the window runs, ``Reservoir`` keeps a sample of blocks drawn from the
seed, and from each the results of a sample of each op's requests; the rest
of each block's output is dropped when the next block starts.  After the
window the program's state is freed and ``check.compare`` holds the kept
results to the reference.

With ``trace``, a first part of the window (``TRACE_SECONDS``) runs under
``torch.profiler``, then the window runs its ``seconds`` as without.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np

from . import check, trace as tracing
from .inputs import Inputs, make_inputs, plain_pool_on_device, pool_on_device
from .traffic import STREAM_SAMPLE, has_plain, make_blocks, rng

HELD_BLOCKS = 2
# results kept from each held block, by op
SAMPLE = {"mul": 12, "add": 6, "sub": 4,
          "mul_plain": 12, "add_plain": 6, "sub_plain": 4, "plain_sub": 4}
TRACE_SECONDS = 1.0
P95 = 0.95


@dataclasses.dataclass
class Observed:
    """What the per-layer readers read (``bench_port/metrics``)."""
    shapes: dict
    trace: Optional[tracing.Trace]


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    observed: Optional[Observed]
    numbers: dict                   # the compared numbers
    memory_peak_bytes: int
    setup_phases: Dict[str, float]  # seconds of each part of set-up
    block_ms: Dict[str, float]      # the window's blocks: count, spread
    reference: check.Reference
    samples: List[check.Sample]


class Reservoir:
    """A uniform sample of ``size`` blocks of the window, drawn from the
    seed without knowing how many blocks the window holds; from each kept
    block, the results of up to ``SAMPLE[op]`` requests of each op."""

    def __init__(self, size: int, g: np.random.Generator):
        self.size, self.g = size, g
        self.kept: List[tuple] = []
        self.seen = 0

    def offer(self, position: int, block, out) -> None:
        import torch
        slot = self.seen if self.seen < self.size else int(
            self.g.integers(0, self.seen + 1))
        self.seen += 1
        if slot >= self.size:
            return
        rows = []
        for op, (idxs, arr) in out.items():
            take = min(SAMPLE.get(op, 0), len(idxs), arr.shape[0])
            pos = np.sort(self.g.choice(len(idxs), size=take, replace=False))
            got = arr.index_select(0, torch.as_tensor(pos, device=arr.device))
            rows.append(([idxs[p] for p in pos], got))
        entry = (position, block, rows)
        if slot < len(self.kept):
            self.kept[slot] = entry
        else:
            self.kept.append(entry)

    def samples(self) -> List[check.Sample]:
        """The kept results on the host, one ``Sample`` each."""
        out = []
        for position, block, rows in self.kept:
            for requests, got in rows:
                host = got.cpu().numpy().view(np.uint64)
                for r, res in zip(requests, host):
                    a, b = (int(x) for x in block.idx[r])
                    out.append(check.Sample(position, block.ops[r], int(r),
                                            a, b, res))
        return out


def missing(out, requests: int) -> int:
    """Requests of a block that got no result row (host metadata only)."""
    return requests - sum(min(len(idxs), arr.shape[0])
                          for idxs, arr in out.values())


def shapes_of(inp: Inputs, traffic: dict) -> dict:
    """The sizes the roofline readers count a block's work from."""
    ctx = inp.ctx
    shapes = {"n": ctx.n, "k": ctx.k, "k_key": ctx.k_key,
              "nbsk": len(ctx.Bsk), "q_moduli": list(ctx.q_mods),
              "m_sk": ctx.m_sk, "pool": traffic["pool"],
              "requests": traffic["requests"], "mix": dict(traffic["mix"])}
    if "plain_pool" in traffic:
        shapes["plain_pool"] = traffic["plain_pool"]
    return shapes


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> Outcome:
    import torch
    from fhe_precompiles_tpu_torch.bfv.golden import PublicKey, RelinKeys
    from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
    from fhe_precompiles_tpu_torch.params import Params
    from fhe_precompiles_tpu_torch.parallel.stream import RequestStream

    t_start = time.perf_counter() if t_start is None else t_start
    phases: Dict[str, float] = {}
    mark = [t_start]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    phase("loading")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    inp = make_inputs(cfg, traffic, seed)
    blocks = make_blocks(traffic, seed)
    phase("keys_and_encryptions")
    params = Params(poly_modulus_degree=inp.ctx.n,
                    coeff_modulus=tuple(inp.ctx.params.coeff_modulus),
                    plain_modulus=inp.ctx.t)
    pk = PublicKey(params, inp.pk.data, RelinKeys(params, inp.pk.relin.data))
    stream = RequestStream(TorchEngine(params, device=device),
                           max_batch=cfg["max_batch"])
    phase("engine")
    pool = pool_on_device(inp, dev)
    plains = ({"plains": plain_pool_on_device(inp, dev)}
              if has_plain(traffic) else {})
    phase("pool")
    R = traffic["requests"]

    def call(block):
        return stream.run_pooled_fused(block.ops, block.idx, pool, pk,
                                       **plains)

    warm = [call(blocks[i % len(blocks)]) for i in range(HELD_BLOCKS + 1)]
    Reservoir(1, rng(seed, STREAM_SAMPLE)).offer(0, blocks[0], warm[0])
    del warm
    if cuda:
        torch.cuda.synchronize(dev)
    # set-up's objects stay for the run: the collector need not walk them
    # again while the window runs
    gc.collect()
    gc.freeze()
    phase("warm_up")
    setup_s = time.perf_counter() - t_start

    reservoir = Reservoir(HELD_BLOCKS, rng(seed, STREAM_SAMPLE))
    count, failed = 0, 0

    def issue(block):
        nonlocal count, failed
        out = call(block)
        failed += missing(out, R)
        reservoir.offer(count, block, out)
        count += 1

    observed = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        traced = 0
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                t0 = time.perf_counter()
                while True:
                    with record_function(tracing.BLOCK):
                        issue(blocks[count % len(blocks)])
                    traced += 1
                    if time.perf_counter() - t0 >= min(TRACE_SECONDS,
                                                       seconds):
                        break
        observed = Observed(shapes_of(inp, traffic),
                            tracing.from_profiler(prof, traced))

    walls: List[float] = []
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        issue(blocks[count % len(blocks)])
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        if t1 - w0 >= seconds:
            break
    window_s = t1 - w0
    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    samples = reservoir.samples()
    del stream, pool, plains, reservoir, call
    if cuda:
        torch.cuda.empty_cache()
    ref = check.Reference(inp)
    numbers = check.compare(ref, samples)
    correct = (failed == 0 and numbers["results_compared"] > 0
               and check.within_limits(numbers))
    e2e = {"requests_per_s": R * len(walls) / window_s,
           "block_p95_ms": 1e3 * percentile(walls, P95),
           "setup_s": setup_s}
    block_ms = {"blocks": len(walls),
                "min": 1e3 * min(walls),
                "median": 1e3 * statistics.median(walls),
                "max": 1e3 * max(walls),
                "median_by_fifth": [1e3 * statistics.median(part) for part in
                                    np.array_split(np.array(walls), 5)
                                    if len(part)]}
    return Outcome(correct, R * count, failed, e2e, observed, numbers,
                   memory_peak, phases, block_ms, ref, samples)

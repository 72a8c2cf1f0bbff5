"""Batched precompile request stream, on one device or over a mesh.

The port's counterpart of ``fhe_precompiles_tpu/parallel/stream.py``: a mixed
stream of add / sub / mul requests on size-2 ciphertexts is grouped by op
kind, and each group runs as batches of at most ``max_batch`` through
``TorchEngine`` on its device.

A pooled call (``run_pooled``, ``run_pooled_fused``) plans its block once
on the host (``plan_block``: the requests grouped by op in a few numpy
passes), checks that every operand index lies in the pool (an
``IndexError`` naming the request, before anything goes to the device),
uploads the plan once (the operand indices in the plan's order, and the
relin keys where the block multiplies) from a pinned buffer without
waiting, and waits for the card only at its end, in the stream's
synchronize.  On a CUDA engine each such call adds one to each of
``stream_counts``: ``plan_uploads`` and ``waits``.  Add and sub read their
operands from the pool by index (``ops/pooled.py`` ``pooled_addsub``: one
kernel launch on the card), in ``run_pooled_fused`` once for the whole
group on the card and a batch at a time on the CPU; a multiply gathers its
operands (``index_select``), and ``max_batch`` cuts its group into batches
that are concatenated.

With a ``mesh`` (``parallel.mesh``, axes ``dp`` and ``tp``), every rank of
the mesh calls ``run`` with the same requests.  Each batch is padded on the
host to a multiple of dp by repeating row 0, each rank takes its dp slice
(and, with ``shard_limbs``, its slice of the k limbs over tp) and computes
it on its own device; the slices are all-gathered over tp, then dp, the
padding is trimmed, and every rank returns the full list.  Under
``shard_limbs``, add and sub run on the rank's limbs; a multiply needs
every limb (base extension and key switching mix them), so its operands
are all-gathered over tp first, ``_mul_relin`` runs on whole ciphertexts
and the rank keeps its limbs.  The port's ``tp`` is therefore a placement,
not a speed-up: the ranks of one tp line compute the same multiplies.

Each local step between two collectives ends with the ranks agreeing that
it succeeded on all of them (``mesh.checked``): a step that fails on one
rank raises ``RankFault`` on every rank, after the same collectives, so
that no rank pairs a later collective with another batch's.

What differs from the JAX version:

* No power-of-two buckets: XLA compiles one program per shape, so the JAX
  version pads every batch to a power-of-two bucket; the port's kernels
  take any row count, so a batch is sent at its real size, padded on a mesh
  only to the next multiple of dp.  ``bucket_batch`` stays as an API and,
  unlike the JAX version, never returns more than ``max_batch`` (rounded up
  to a multiple of dp) for a count that fits in one batch.
* ``run_pooled`` and ``run_pooled_fused`` shard nothing under a mesh (as in
  the JAX version, whose pooled programs take no mesh placement): each rank
  runs them whole on its device.  ``run_pooled_fused`` is a loop over
  chunks on the device where the JAX version scans inside one jitted
  program.
* The relin keys go to the engine as they are (``TorchEngine`` takes no
  Shoup table; the bytes are the same).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..bfv.golden import Ciphertext, PublicKey
from ..ops.engine import TorchEngine
from ..ops.modmath import addmod, submod
from ..ops.pooled import pooled_addsub
from .mesh import (Mesh, all_gather_axis, checked, gather_ct_batch,
                   limb_range, same_device, shard_ct_batch)

OPS = ("add", "sub", "mul")


@dataclasses.dataclass
class Request:
    op: str                     # "add" | "sub" | "mul"
    a: np.ndarray               # (2, k, n) uint64 ciphertext data
    b: np.ndarray


def bucket_batch(n: int, dp: int, max_batch: int) -> int:
    """Smallest dp * 2^j >= n, but never more than max_batch rounded up to a
    multiple of dp when n fits into one batch (n <= max_batch): the result
    is a multiple of dp and, for such n, lies in [n, max_batch] where dp
    divides max_batch."""
    d = max(1, dp)
    t = d
    while t < n:
        t *= 2
    return min(t, -(-max(n, max_batch) // d) * d)


# each op as the four bytes of ``op + "|"``, a little-endian word: a block's
# ops joined with "|" are read as one array of words in a single pass
_OP_WORDS = np.array([int.from_bytes((op + "|").encode(), "little")
                      for op in OPS], dtype=np.uint32)

# what the pooled calls on a CUDA engine do: ``plan_uploads`` counts the
# uploads of a block's plan (its operand indices and relin keys), ``waits``
# the synchronizes that end the calls; each call adds one to each, so a
# count above the calls made means a second upload or wait in a block
stream_counts = {"plan_uploads": 0, "waits": 0}


def reset_stream_counts() -> None:
    for name in stream_counts:
        stream_counts[name] = 0


@dataclasses.dataclass
class BlockPlan:
    """A block's requests grouped by op: the groups in the order their op
    first appears, each group's request indices ascending; group ``g`` is
    ``ops[g]`` on ``order[starts[g]:starts[g + 1]]``."""
    ops: Tuple[str, ...]
    order: np.ndarray           # (R,) int64 request indices, grouped
    starts: List[int]           # len(ops) + 1 offsets into order

    def spans(self):
        """(op, start, end) of each group in ``order``."""
        return zip(self.ops, self.starts[:-1], self.starts[1:])

    def groups(self) -> Dict[str, List[int]]:
        return {op: self.order[s:e].tolist() for op, s, e in self.spans()}


def _op_codes(ops: Sequence[str]) -> np.ndarray:
    """The index into OPS of each op; ValueError names the first unknown."""
    codes = np.full(len(ops), -1, dtype=np.int8)
    try:
        raw = ("|".join(ops) + "|").encode("ascii")
    except (TypeError, UnicodeEncodeError):
        raw = b""
    if len(raw) == 4 * len(ops):
        words = np.frombuffer(raw, dtype="<u4")
        for c, w in enumerate(_OP_WORDS):
            codes[words == w] = c
    if len(ops) and codes.min() < 0:
        # a word matches only an op and its separator, so a block that
        # joins into words all known holds known ops alone
        for op in ops:
            if op not in OPS:
                raise ValueError(f"unknown op {op!r}")
    return codes


def plan_block(ops: Sequence[str]) -> BlockPlan:
    """Groups a block's requests by op in a few numpy passes."""
    codes = _op_codes(ops)
    by_code = np.argsort(codes, kind="stable")
    ends = np.cumsum(np.bincount(codes, minlength=len(OPS))).tolist()
    # (first request, op code, span in by_code) of each op present, in the
    # order of the first requests
    groups = sorted((by_code[s], c, s, e) for c, (s, e)
                    in enumerate(zip([0] + ends[:-1], ends)) if e > s)
    order = np.concatenate([by_code[s:e] for _, _, s, e in groups]
                           or [by_code])
    starts = np.cumsum([0] + [e - s for _, _, s, e in groups]).tolist()
    return BlockPlan(tuple(OPS[c] for _, c, _, _ in groups), order, starts)


class RequestStream:
    """Groups mixed add/sub/mul requests and runs them batched on the
    engine's device, or over `mesh` (whose device must be the engine's);
    each group is cut into batches of at most ``max_batch``."""

    def __init__(self, engine: TorchEngine, mesh: Optional[Mesh] = None,
                 shard_limbs: bool = False, max_batch: int = 128):
        if max_batch < 1:
            raise ValueError("max_batch must be at least 1")
        if mesh is not None:
            if "dp" not in mesh.shape:
                raise ValueError(f"mesh {mesh.shape} has no dp axis")
            if not same_device(mesh.device, engine.device):
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{engine.device}")
            if shard_limbs:
                limb_range(mesh, engine.k)      # k must split over tp
        self.engine = engine
        self.mesh = mesh
        self.shard_limbs = shard_limbs
        self.max_batch = max_batch
        # the host side of a pooled call's one upload, grown to the largest
        # block (pinned on a CUDA engine), and the lock that gives it to one
        # call at a time
        self._staging: Optional[torch.Tensor] = None
        self._staging_lock = threading.Lock()

    def _relin_keys(self, ops, pk: PublicKey,
                    device=None) -> Optional[torch.Tensor]:
        if "mul" not in ops:
            return None
        if pk.relin is None:
            raise ValueError("mul requests need relin keys in the pk")
        return convert.relin_keys_from_numpy(
            pk.relin.data, self.engine.device if device is None else device)

    def _dispatch(self, op: str, a: torch.Tensor, b: torch.Tensor,
                  rk: Optional[torch.Tensor]) -> torch.Tensor:
        eng = self.engine
        if op == "add":
            return eng._add(a, b)
        if op == "sub":
            return eng._sub(a, b)
        if op == "mul":
            return eng._mul_relin(a, b, rk)
        raise ValueError(f"unknown op {op!r}")

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            stream_counts["waits"] += 1
            torch.cuda.synchronize(self.engine.device)

    def _run_sharded(self, op: str, chunk: Sequence[Request],
                     rk: Optional[torch.Tensor]) -> np.ndarray:
        """One batch over the mesh: padded to a multiple of dp with row 0,
        this rank's shard computed, the shards all-gathered, the padding
        trimmed.  Each local step ends in ``checked``: a step that fails
        on one rank raises ``RankFault`` on every rank, after the same
        collectives."""
        mesh, eng, rows = self.mesh, self.engine, len(chunk)
        limbs = self.shard_limbs

        def shards():
            pad = [chunk[0]] * (-rows % mesh.axis_size("dp"))
            return tuple(shard_ct_batch(np.stack([getattr(r, side)
                                                  for r in chunk + pad]),
                                        mesh, limbs) for side in "ab")

        if limbs and op == "mul":
            # the multiply mixes limbs: whole ciphertexts in, this rank's
            # limbs kept
            a, b = checked(mesh, shards)
            a = all_gather_axis(a, mesh, "tp", dim=2)
            b = all_gather_axis(b, mesh, "tp", dim=2)
            lo, hi = limb_range(mesh, eng.k)
            out = checked(mesh, lambda: eng._mul_relin(a, b, rk)
                          [:, :, lo:hi].contiguous())
        else:
            def local():
                a, b = shards()
                if not limbs:
                    return self._dispatch(op, a, b, rk)
                lo, hi = limb_range(mesh, eng.k)
                q = eng.q_mods[lo:hi]
                return addmod(a, b, q) if op == "add" else submod(a, b, q)
            out = checked(mesh, local)
        full = gather_ct_batch(out, mesh, limbs)
        return checked(mesh, lambda: convert.to_numpy(full)[:rows])

    def run(self, requests: Sequence[Request],
            pk: PublicKey) -> List[np.ndarray]:
        """Execute a mixed stream; returns per-request (2, k, n) uint64
        results in input order.  Each batch goes to the device once and
        comes back to the host once; on a mesh every rank returns the
        whole list, or every rank raises ``RankFault``."""
        if self.mesh is not None:
            groups, rk = checked(self.mesh, lambda: self._plan(requests, pk))
        else:
            groups, rk = self._plan(requests, pk)
        dev = self.engine.device
        results: List[Optional[np.ndarray]] = [None] * len(requests)
        for op, idxs in groups.items():
            for c0 in range(0, len(idxs), self.max_batch):
                chunk = idxs[c0:c0 + self.max_batch]
                if self.mesh is not None:
                    host = self._run_sharded(
                        op, [requests[i] for i in chunk], rk)
                else:
                    a = convert.ciphertexts_from_numpy(
                        [requests[i].a for i in chunk], dev)
                    b = convert.ciphertexts_from_numpy(
                        [requests[i].b for i in chunk], dev)
                    host = convert.to_numpy(self._dispatch(op, a, b, rk))
                for slot, i in enumerate(chunk):
                    results[i] = host[slot]
        return results  # type: ignore[return-value]

    def _plan(self, requests: Sequence[Request], pk: PublicKey):
        """(the request indices by op, the relin keys on the device)."""
        groups = plan_block([r.op for r in requests]).groups()
        return groups, self._relin_keys(groups, pk)

    def _pool(self, ct_pool) -> torch.Tensor:
        if isinstance(ct_pool, torch.Tensor):
            return ct_pool.to(self.engine.device).contiguous()
        return convert.ciphertexts_from_numpy(np.asarray(ct_pool),
                                              self.engine.device)

    def _stage(self, ops: Sequence[str], idx_pairs: np.ndarray,
               pk: PublicKey, pool_rows: int):
        """The block's plan, its operand indices on the device in the plan's
        order ((2, R): the a rows, then the b rows) and the relin keys
        there, all in one upload.  An index outside [0, pool_rows) raises
        ``IndexError`` naming its request, before the upload: the kernels
        that read by index must not read outside the pool.  On a CUDA
        engine the words are written into the stream's pinned buffer and
        copied with ``non_blocking``: nothing waits for the card.  Reusing
        that buffer is safe because a pooled call ends in its own
        synchronize, so the last call's copy out of it has finished before
        the next call writes it."""
        plan = plan_block(ops)
        idx = np.asarray(idx_pairs, dtype=np.int64).reshape(-1, 2)
        R = len(plan.order)
        used = idx[:R]
        if R and (used.min() < 0 or used.max() >= pool_rows):
            r = int(np.flatnonzero(((used < 0) | (used >= pool_rows))
                                   .any(axis=1))[0])
            raise IndexError(f"request {r}: operand indices "
                             f"{used[r].tolist()} outside the pool of "
                             f"{pool_rows} ciphertexts")
        rk = self._relin_keys(plan.ops, pk, device="cpu")
        nk = 0 if rk is None else rk.numel()
        dev = self.engine.device
        if dev.type == "cuda":
            if self._staging is None or self._staging.numel() < nk + 2 * R:
                self._staging = torch.empty(nk + 2 * R, dtype=torch.int64,
                                            pin_memory=True)
            host = self._staging[:nk + 2 * R]
        else:
            host = torch.empty(nk + 2 * R, dtype=torch.int64)
        words = host.numpy()
        # the keys first: a kernel reads them from the buffer's aligned start
        if rk is not None:
            words[:nk] = rk.reshape(-1).numpy()
        np.take(idx[:, 0], plan.order, out=words[nk:nk + R])
        np.take(idx[:, 1], plan.order, out=words[nk + R:])
        if dev.type == "cuda":
            stream_counts["plan_uploads"] += 1
            host = host.to(dev, non_blocking=True)
        rows = host[nk:].view(2, R)
        return plan, rows, None if rk is None else host[:nk].view(rk.shape)

    def _batches(self, rows: torch.Tensor, start: int, end: int,
                 size: Optional[int] = None):
        """(first, last + 1, a rows, b rows) of each batch of a group, of at
        most `size` requests (by default ``max_batch``)."""
        size = size or self.max_batch
        for c0 in range(start, end, size):
            c1 = min(c0 + size, end)
            yield c0, c1, rows[0, c0:c1], rows[1, c0:c1]

    def run_pooled(self, ops: Sequence[str], idx_pairs: np.ndarray,
                   ct_pool, pk: PublicKey
                   ) -> List[Tuple[List[int], torch.Tensor]]:
        """Requests name operands by their index into a pool of ciphertexts
        (P, 2, k, n) that is moved to the device once; the operands are
        read there and the results stay there.  Returns
        (request_indices, batch) pairs, one a batch of at most
        ``max_batch``.  The block is planned and uploaded once
        (``_stage``); the call waits for the card only at its end."""
        pool = self._pool(ct_pool)
        with self._staging_lock:
            plan, rows, rk = self._stage(ops, idx_pairs, pk, pool.shape[0])
            try:
                batches = []
                for op, s, e in plan.spans():
                    for c0, c1, ra, rb in self._batches(rows, s, e):
                        res = (pooled_addsub(pool, ra, rb,
                                             self.engine.golden.q_mods,
                                             op == "sub")
                               if op != "mul" else self._dispatch(
                                   op, pool.index_select(0, ra),
                                   pool.index_select(0, rb), rk))
                        batches.append((plan.order[c0:c1].tolist(), res))
            finally:
                self._sync()
        return batches

    def run_pooled_fused(self, ops: Sequence[str], idx_pairs: np.ndarray,
                         ct_pool, pk: PublicKey
                         ) -> Dict[str, Tuple[List[int], torch.Tensor]]:
        """Like ``run_pooled``, but returns one array a kind:
        {op: (request_indices, (M, 2, k, n) results)}.  On the card an add
        or sub group is one ``pooled_addsub`` over the whole group, written
        straight into its result, and ``max_batch`` cuts the multiplies
        alone; on the CPU it cuts every group.  When the pool
        holds at most two ciphertexts a multiply (P <= 2 M), the
        operand-independent half of the multiply (Bsk lift and forward
        transforms, ``TorchEngine._prepare``) runs once a pooled ciphertext
        instead of once an operand."""
        pool = self._pool(ct_pool)
        eng = self.engine
        with self._staging_lock:
            plan, rows, rk = self._stage(ops, idx_pairs, pk, pool.shape[0])
            try:
                out = {}
                for op, s, e in plan.spans():
                    if op != "mul":
                        # one launch a group on the card, whose kernel holds
                        # no intermediates; the CPU's plain version builds
                        # its gathers and temporaries a batch at a time
                        res = pool.new_empty((e - s, *pool.shape[1:]))
                        for c0, c1, ra, rb in self._batches(
                                rows, s, e, e - s if pool.is_cuda else None):
                            pooled_addsub(pool, ra, rb, eng.golden.q_mods,
                                          op == "sub", out=res[c0 - s:c1 - s])
                    else:
                        prepared = (eng._prepare(pool)
                                    if pool.shape[0] <= 2 * (e - s) else None)
                        res = torch.cat([
                            eng._mul_relin_prepared(
                                prepared.index_select(0, ra),
                                prepared.index_select(0, rb), rk)
                            if prepared is not None
                            else self._dispatch(op, pool.index_select(0, ra),
                                                pool.index_select(0, rb), rk)
                            for _, _, ra, rb in self._batches(rows, s, e)])
                    out[op] = (plan.order[s:e].tolist(), res)
            finally:
                self._sync()
        return out

    def make_mixed_requests(self, cts: Sequence[Ciphertext], count: int,
                            mix=(0.45, 0.1, 0.45), seed: int = 0
                            ) -> List[Request]:
        """Synthesize `count` mixed add/sub/mul requests from sample cts
        (the JAX version's draws: the same seed gives the same stream)."""
        rng = np.random.default_rng(seed)
        ops = rng.choice(["add", "sub", "mul"], size=count, p=list(mix))
        picks = rng.integers(0, len(cts), size=(count, 2))
        return [Request(str(op), cts[i].data, cts[j].data)
                for op, (i, j) in zip(ops, picks)]

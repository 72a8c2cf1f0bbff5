"""Batched precompile request stream, on one device or over a mesh.

The port's counterpart of ``fhe_precompiles_tpu/parallel/stream.py``: a mixed
stream of add / sub / mul requests on size-2 ciphertexts is grouped by op
kind, and each group runs as batches of at most ``max_batch`` through
``TorchEngine`` on its device.

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..bfv.golden import Ciphertext, PublicKey
from ..ops.engine import TorchEngine
from ..ops.modmath import addmod, submod
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


def _group_by_op(ops: Sequence[str]) -> Dict[str, List[int]]:
    order: Dict[str, List[int]] = {}
    for i, op in enumerate(ops):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        order.setdefault(op, []).append(i)
    return order


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

    def _relin_keys(self, ops, pk: PublicKey) -> Optional[torch.Tensor]:
        if "mul" not in ops:
            return None
        if pk.relin is None:
            raise ValueError("mul requests need relin keys in the pk")
        return convert.relin_keys_from_numpy(pk.relin.data,
                                             self.engine.device)

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
        groups = _group_by_op([r.op for r in requests])
        return groups, self._relin_keys(groups, pk)

    def _pool(self, ct_pool) -> torch.Tensor:
        if isinstance(ct_pool, torch.Tensor):
            return ct_pool.to(self.engine.device)
        return convert.ciphertexts_from_numpy(np.asarray(ct_pool),
                                              self.engine.device)

    def run_pooled(self, ops: Sequence[str], idx_pairs: np.ndarray,
                   ct_pool, pk: PublicKey
                   ) -> List[Tuple[List[int], torch.Tensor]]:
        """Requests name operands by their index into a pool of ciphertexts
        (P, 2, k, n) that is moved to the device once; the operands are
        gathered there and the results stay there.  Returns
        (request_indices, batch) pairs, one a batch of at most
        ``max_batch``."""
        pool = self._pool(ct_pool)
        order = _group_by_op(ops)
        rk = self._relin_keys(order, pk)
        idx = torch.as_tensor(np.asarray(idx_pairs, dtype=np.int64),
                              device=pool.device)
        batches = []
        for op, idxs in order.items():
            for c0 in range(0, len(idxs), self.max_batch):
                chunk = idxs[c0:c0 + self.max_batch]
                rows = idx[chunk]
                a = pool.index_select(0, rows[:, 0])
                b = pool.index_select(0, rows[:, 1])
                batches.append((chunk, self._dispatch(op, a, b, rk)))
        self._sync()
        return batches

    def run_pooled_fused(self, ops: Sequence[str], idx_pairs: np.ndarray,
                         ct_pool, pk: PublicKey
                         ) -> Dict[str, Tuple[List[int], torch.Tensor]]:
        """Like ``run_pooled``, but returns one array a kind:
        {op: (request_indices, (M, 2, k, n) results)}.  When the pool holds
        at most two ciphertexts a multiply (P <= 2 M), the
        operand-independent half of the multiply (Bsk lift and forward
        transforms, ``TorchEngine._prepare``) runs once a pooled ciphertext
        instead of once an operand."""
        pool = self._pool(ct_pool)
        order = _group_by_op(ops)
        rk = self._relin_keys(order, pk)
        idx = torch.as_tensor(np.asarray(idx_pairs, dtype=np.int64),
                              device=pool.device)
        eng = self.engine
        out = {}
        for op, idxs in order.items():
            prepared = (eng._prepare(pool)
                        if op == "mul" and pool.shape[0] <= 2 * len(idxs)
                        else None)
            outs = []
            for c0 in range(0, len(idxs), self.max_batch):
                rows = idx[idxs[c0:c0 + self.max_batch]]
                if prepared is not None:
                    outs.append(eng._mul_relin_prepared(
                        prepared.index_select(0, rows[:, 0]),
                        prepared.index_select(0, rows[:, 1]), rk))
                else:
                    outs.append(self._dispatch(
                        op, pool.index_select(0, rows[:, 0]),
                        pool.index_select(0, rows[:, 1]), rk))
            out[op] = (idxs, torch.cat(outs))
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

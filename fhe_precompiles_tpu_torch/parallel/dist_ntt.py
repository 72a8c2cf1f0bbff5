"""Distributed negacyclic NTT: the coefficient axis sharded over the ranks
of one mesh axis.

The port's counterpart of ``fhe_precompiles_tpu/parallel/dist_ntt.py``.
The ring dimension n plays the part of sequence length: D ranks hold
S = n / D coefficients each.  Forward (Cooley-Tukey, as ``ops/ntt.py``):

  * stages m = 1, 2, ..., D/2: the partner distance t = n / (2m) is at
    least S, so shard s pairs with shard s ^ (t / S).  The two swap their
    whole shards (``_pair_swap``) and each keeps its half of the butterfly;
    the whole shard shares one twiddle, root[m + s // (2 t / S)].
  * stages m = D, ..., n/2: every block lies inside one shard, which runs
    them with its slice root[m + s bs : m + (s + 1) bs] of the stage's
    twiddles (bs blocks a shard).

The inverse (Gentleman-Sande) runs its local stages first and its last
log2 D stages across shards, then multiplies by n^-1.  The output is the
local transform's, word for word, SEAL's bit-reversed layout included.

The stages are plain torch with ``ops/modmath``'s exact ``addmod``,
``submod`` and ``mulmod`` (the JAX version's are plain ``jnp`` under
``shard_map`` with Shoup products on canonical values: the same words).
There is no kernel here: the JAX version reaches no ``pl.pallas_call``.

Every rank of the axis builds its transforms from the same tables and
calls them on its own (..., L, S) shard (``shard_coeff_axis``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.modmath import addmod, mulmod, submod
from ..ops.ntt import NttTables
from .mesh import Mesh, exchange, replicate, same_device


def _pair_swap(x: torch.Tensor, mesh: Mesh, axis: str,
               partner: int) -> torch.Tensor:
    """Swap whole shards with index `partner` along `axis`."""
    return exchange(x, mesh, axis, partner, partner)


def make_distributed_ntt(tables: NttTables, mesh: Mesh, axis: str = "sp"
                         ) -> Tuple[Callable, Callable]:
    """(ntt_fn, intt_fn) on this rank's (..., L, n / D) int64 shard, where
    D is the size of `axis`; `tables` (``ops.ntt.build_tables``) on the
    mesh's device.  Equal, shard for shard, to ``ops.ntt.ntt`` / ``intt``
    (with the tables' n^-1)."""
    D = mesh.axis_size(axis)
    n = tables.n
    S = n // D
    if S * D != n or S < 2:
        raise ValueError(f"n={n} not shardable over {D} devices")
    if not same_device(tables.p.device, mesh.device):
        raise ValueError(f"tables on {tables.p.device}, mesh on "
                         f"{mesh.device}")
    s = mesh.axis_index(axis)
    L = tables.p.shape[0]
    p, p3 = tables.p, tables.p.reshape(L, 1, 1)

    def cross(table, m):
        """(partner, holds the low half, twiddle (L, 1)) at stage m."""
        stride = (n // (2 * m)) // S        # partner distance in shards
        blk = s // (2 * stride)
        return s ^ stride, (s // stride) % 2 == 0, \
            table[:, m + blk:m + blk + 1]

    def local(table, m):
        """(blocks a shard, half-block t, twiddles (L, bs, 1)) at m."""
        t = n // (2 * m)
        bs = S // (2 * t)
        return bs, t, table[:, m + s * bs:m + (s + 1) * bs].reshape(L, bs, 1)

    log_d = D.bit_length() - 1          # D divides n, a power of two
    fwd_cross = [cross(tables.root, 1 << j) for j in range(log_d)]
    fwd_local = [local(tables.root, m) for m in
                 (1 << j for j in range(log_d, n.bit_length() - 1))]
    inv_local = [local(tables.inv_root, m) for m in
                 (1 << j for j in range(n.bit_length() - 2, log_d - 1, -1))]
    inv_cross = [cross(tables.inv_root, 1 << j)
                 for j in range(log_d - 1, -1, -1)]

    def check(x: torch.Tensor) -> None:
        if x.dtype != torch.int64 or tuple(x.shape[-2:]) != (L, S):
            raise ValueError(f"expected an int64 (..., {L}, {S}) shard, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != tables.p.device:
            raise ValueError(f"shard on {x.device}, tables on "
                             f"{tables.p.device}")

    def ntt_fn(x: torch.Tensor) -> torch.Tensor:
        check(x)
        for partner, is_lo, w in fwd_cross:
            recv = _pair_swap(x, mesh, axis, partner)
            if is_lo:
                x = addmod(x, mulmod(recv, w, p), p)
            else:
                x = submod(recv, mulmod(x, w, p), p)
        shape = x.shape
        for bs, t, w in fwd_local:
            v = x.reshape(shape[:-1] + (bs, 2, t))
            lo = v[..., 0, :]
            hi = mulmod(v[..., 1, :], w, p3)
            x = torch.stack([addmod(lo, hi, p3), submod(lo, hi, p3)],
                            dim=-2).reshape(shape)
        return x.contiguous()

    def intt_fn(x: torch.Tensor) -> torch.Tensor:
        check(x)
        shape = x.shape
        for bs, t, w in inv_local:
            v = x.reshape(shape[:-1] + (bs, 2, t))
            lo, hi = v[..., 0, :], v[..., 1, :]
            x = torch.stack([addmod(lo, hi, p3),
                             mulmod(submod(lo, hi, p3), w, p3)],
                            dim=-2).reshape(shape)
        for partner, is_lo, w in inv_cross:
            recv = _pair_swap(x, mesh, axis, partner)
            if is_lo:
                x = addmod(x, recv, p)
            else:
                x = mulmod(submod(recv, x, p), w, p)
        return mulmod(x, tables.n_inv, p).contiguous()

    return ntt_fn, intt_fn


def shard_coeff_axis(x, mesh: Mesh, axis: str = "sp") -> torch.Tensor:
    """This rank's slice of the coefficient axis of (..., L, n) (numpy
    uint64 or an int64 tensor), an int64 tensor on the mesh's device."""
    D = mesh.axis_size(axis)
    n = x.shape[-1]
    if n % D:
        raise ValueError(f"n={n} not shardable over {D} devices")
    S, s = n // D, mesh.axis_index(axis)
    return replicate(x[..., s * S:(s + 1) * S], mesh)

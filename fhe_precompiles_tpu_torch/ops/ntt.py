"""Negacyclic NTT over stacks of RNS limbs as plain torch stage loops.

Same transform as ``bfv/ntt.py`` (Cooley-Tukey forward, Gentleman-Sande
inverse, twiddles in SEAL's bit-reversed layout), vectorised over tensors
shaped ``(..., L, n)`` where row ``l`` of the limb axis is reduced mod
``moduli[l]``.  Forward input and every output are canonical residues.

The schedule is the plainest exact one: radix 2, one pass per stage, every
butterfly fully reduced.  The JAX reference fuses stages and keeps values
lazy between them; both are exact arithmetic on canonical inputs, so they
give the same bytes.  These loops are the plain version that the hand-written
NTT kernels of a later slice will be held against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..bfv.modmath import get_ntt_tables
from .modmath import addmod, mulmod, submod


@dataclasses.dataclass(frozen=True)
class NttTables:
    """Twiddle tables for a stack of L moduli, int64 tensors on one device."""

    n: int
    p: torch.Tensor             # (L, 1)
    root: torch.Tensor          # (L, n) forward twiddles, bit-reversed order
    inv_root: torch.Tensor      # (L, n)
    n_inv: torch.Tensor         # (L, 1): n^-1 (times the folded factor) mod p


def _dev(arr, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint64).view(np.int64)).to(device)


def build_tables(moduli: Sequence[int], n: int, device,
                 n_inv_factors: Optional[Sequence[int]] = None) -> NttTables:
    """Tables on `device`, which the caller names (there is no default).
    n_inv_factors: optional per-limb constants folded into the inverse
    transform's n^-1 multiply, so that ``intt`` returns ``factor * x``
    without a separate pass (the engine folds t and t * q_hat_inv there)."""
    tabs = [get_ntt_tables(int(p), n) for p in moduli]
    n_inv = [int(t.n_inv) for t in tabs]
    if n_inv_factors is not None:
        n_inv = [v * int(f) % int(p)
                 for v, f, p in zip(n_inv, n_inv_factors, moduli)]
    col = lambda v: np.array(v, dtype=np.uint64).reshape(-1, 1)  # noqa: E731
    return NttTables(
        n=n,
        p=_dev(col([int(p) for p in moduli]), device),
        root=_dev(np.stack([t.root_powers for t in tabs]), device),
        inv_root=_dev(np.stack([t.inv_root_powers for t in tabs]), device),
        n_inv=_dev(col(n_inv), device),
    )


def ntt(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Forward NTT along the last axis: natural order in, bit-reversed out."""
    n, L = tb.n, tb.p.shape[0]
    lead = x.shape[:-1]
    p = tb.p.reshape(L, 1, 1)
    a, m, t = x, 1, n
    while m < n:
        t //= 2
        v = a.reshape(lead + (m, 2, t))
        w = tb.root[:, m:2 * m].reshape(L, m, 1)
        lo = v[..., 0, :]
        hi = mulmod(v[..., 1, :], w, p)
        a = torch.stack([addmod(lo, hi, p), submod(lo, hi, p)], dim=-2)
        m *= 2
    return a.reshape(lead + (n,))


def intt(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Inverse NTT: bit-reversed in, natural order out, times tb.n_inv."""
    n, L = tb.n, tb.p.shape[0]
    lead = x.shape[:-1]
    p = tb.p.reshape(L, 1, 1)
    a, m, t = x, n // 2, 1
    while m >= 1:
        v = a.reshape(lead + (m, 2, t))
        w = tb.inv_root[:, m:2 * m].reshape(L, m, 1)
        lo, hi = v[..., 0, :], v[..., 1, :]
        a = torch.stack([addmod(lo, hi, p),
                         mulmod(submod(lo, hi, p), w, p)], dim=-2)
        t *= 2
        m //= 2
    return mulmod(a.reshape(lead + (n,)), tb.n_inv, tb.p)

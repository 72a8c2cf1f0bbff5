"""Exact modular arithmetic on ``torch.int64`` residue tensors.

Same semantics as ``bfv/modmath.py`` (the host golden model).  The carrier
type is int64 on every device: residues are < 2**37 and every lazy value the
path forms is < 2**44, so the sign bit is never reached, and the CUDA kernels
read the same storage as ``unsigned long long``.  numpy ``uint64`` arrays
cross over with ``.view(np.int64)`` (see ``convert.py``).

This is the plain arithmetic behind the plain versions of the kernels and the
engine's elementwise operations.  It may use ``%``; the division-free forms (Shoup, Barrett) live in
``csrc/modmath.cuh``, and the host-side helpers that compute their constants
are here.

Moduli broadcast: ``p`` may be a Python int or a tensor shaped to broadcast
over the data, e.g. ``(L, 1)`` for one op across all RNS limbs.
"""
from __future__ import annotations

import numpy as np
import torch

_S19 = 19
_MASK19 = (1 << 19) - 1


def addmod(a, b, p):
    """(a + b) mod p for a, b < p."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def submod(a, b, p):
    """(a - b) mod p for a, b < p."""
    return torch.where(a >= b, a - b, a + (p - b))


def negmod(a, p):
    """(-a) mod p for a < p; 0 stays 0."""
    return torch.where(a == 0, a, p - a)


def mulmod(a, b, p):
    """(a * b) mod p, exact, for b < p < 2**37 and a < 4p (a may be lazy).

    A 37 x 37-bit product does not fit int64, so ``b`` is split at 19 bits:
    a*(b >> 19) < 2**57, its residue shifted by 19 is < 2**56, and
    a*(b & (2**19 - 1)) < 2**58, so every intermediate stays < 2**59.
    """
    hi = ((a * (b >> _S19)) % p) << _S19
    return (hi + a * (b & _MASK19)) % p


def csub_reduce(x, p, steps: int):
    """x mod p via `steps` conditional subtracts: exact iff x < (steps+1)*p."""
    x, p = torch.broadcast_tensors(x, torch.as_tensor(p, device=x.device))
    for _ in range(steps):
        x = torch.where(x >= p, x - p, x)
    return x


def shoup_precompute(w, p) -> np.ndarray:
    """Host-side exact floor(w * 2**64 / p) as uint64 (elementwise)."""
    w = np.asarray(w, dtype=np.uint64)
    p_b = np.broadcast_to(np.asarray(p, dtype=np.uint64), w.shape)
    out = np.array([(int(x) << 64) // int(q)
                    for x, q in zip(w.reshape(-1), p_b.reshape(-1))],
                   dtype=np.uint64)
    return out.reshape(w.shape)


def shoup40_precompute(w, p) -> np.ndarray:
    """Host-side exact floor(w * 2**40 / p) as uint64 (elementwise): the NTT
    kernels' 40-bit Shoup word, below 2**40 for w < p."""
    w = np.asarray(w, dtype=np.uint64)
    p_b = np.broadcast_to(np.asarray(p, dtype=np.uint64), w.shape)
    out = np.array([(int(x) << 40) // int(q)
                    for x, q in zip(w.reshape(-1), p_b.reshape(-1))],
                   dtype=np.uint64)
    return out.reshape(w.shape)


def barrett_mu(p) -> np.ndarray:
    """Host-side mu = floor(2**64 / p) as uint64 (elementwise)."""
    arr = np.asarray(p, dtype=np.uint64)
    out = np.array([(1 << 64) // int(q) for q in arr.reshape(-1)],
                   dtype=np.uint64)
    return out.reshape(arr.shape)

"""Negacyclic NTT / inverse NTT over numpy uint64 (golden model).

Cooley-Tukey forward / Gentleman-Sande inverse with twiddles in bit-reversed
layout (Longa-Naehrig), matching SEAL's in-memory "NTT form" so that SEAL
key blobs (stored in NTT form) deserialize meaningfully.

Fully vectorized over leading batch dims: operates on arrays shaped (..., n).
The benchmark's frozen copy of the golden transforms.
"""
from __future__ import annotations

import numpy as np

from .modmath import NttTables, addmod, get_ntt_tables, mulmod, submod


def ntt(a: np.ndarray, tables: NttTables) -> np.ndarray:
    """Forward negacyclic NTT; input natural order, output bit-reversed.

    a: uint64 array (..., n) with values < p. Returns a new array.
    """
    p = np.uint64(tables.p)
    n = tables.n
    a = np.ascontiguousarray(a, dtype=np.uint64).copy()
    lead = a.shape[:-1]
    m = 1
    t = n
    while m < n:
        t //= 2
        # shape (..., m, 2, t): blocks of 2t, butterfly between halves
        v = a.reshape(lead + (m, 2, t))
        w = tables.root_powers[m:2 * m].reshape((m, 1))  # per-block twiddle
        lo = v[..., 0, :].copy()          # copy: v aliases a, assignments below
        hi = mulmod(v[..., 1, :], w, p)
        v[..., 0, :] = addmod(lo, hi, p)
        v[..., 1, :] = submod(lo, hi, p)
        m *= 2
    return a


def intt(a: np.ndarray, tables: NttTables) -> np.ndarray:
    """Inverse negacyclic NTT; input bit-reversed (NTT form), output natural."""
    p = np.uint64(tables.p)
    n = tables.n
    a = np.ascontiguousarray(a, dtype=np.uint64).copy()
    lead = a.shape[:-1]
    m = n // 2
    t = 1
    while m >= 1:
        v = a.reshape(lead + (m, 2, t))
        w = tables.inv_root_powers[m:2 * m].reshape((m, 1))
        lo = v[..., 0, :].copy()          # copy: v aliases a
        hi = v[..., 1, :].copy()
        v[..., 0, :] = addmod(lo, hi, p)
        v[..., 1, :] = mulmod(submod(lo, hi, p), w, p)
        t *= 2
        m //= 2
    return mulmod(a, tables.n_inv, p)


def negacyclic_mulmod(a: np.ndarray, b: np.ndarray, p: int, n: int) -> np.ndarray:
    """Negacyclic convolution a*b mod (x^n+1, p) via NTT (both natural order)."""
    tb = get_ntt_tables(int(p), n)
    return intt(mulmod(ntt(a, tb), ntt(b, tb), np.uint64(p)), tb)

"""The control that the comparison of ``bench_port/check.py`` must fail.

The configurations state no precision: their arithmetic is exact, and the
guarantee they state is that every validator produces the canonical bytes
(SEAL's conventions, as ``golden.py`` defines them).  The control breaks that
guarantee with the step that would tempt a faster multiply: relinearization
divides by the special prime P rounding down instead of to the nearest
integer, dropping the P/2 correction.  Its results still decrypt to the right
plaintexts, since the error it adds is below 1 a coefficient, but most of
their words differ from the canonical ones.
"""
from __future__ import annotations

import numpy as np

from .golden import BfvContext, Ciphertext, RelinKeys
from .modmath import addmod, mulmod, submod
from .ntt import intt, ntt


def relinearize_floor(ctx: BfvContext, ct: Ciphertext,
                      rk: RelinKeys) -> Ciphertext:
    """``BfvContext.relinearize`` with the division by P rounded down."""
    n, c2 = ctx.n, ct.data[2]
    acc = np.zeros((2, ctx.k_key, n), dtype=np.uint64)
    for j in range(ctx.k):
        for i, p in enumerate(ctx.key_mods):
            dji = ntt(c2[j] % np.uint64(p), ctx.tables[p])
            for comp in range(2):
                acc[comp, i] = addmod(
                    acc[comp, i], mulmod(dji, rk.data[j, comp, i], p), p)
    for comp in range(2):
        for i, p in enumerate(ctx.key_mods):
            acc[comp, i] = intt(acc[comp, i], ctx.tables[p])
    out = np.empty((2, ctx.k, n), dtype=np.uint64)
    for comp in range(2):
        xP = acc[comp, ctx.k_key - 1]
        for i, p in enumerate(ctx.q_mods):
            ti = submod(acc[comp, i], np.mod(xP, np.uint64(p)), p)
            down = mulmod(ti, np.uint64(ctx.inv_P_mod_q[i]), p)
            out[comp, i] = addmod(ct.data[comp, i], down, p)
    return Ciphertext(ctx.params, out)


def mul_relin_floor(ctx: BfvContext, a: Ciphertext, b: Ciphertext,
                    rk: RelinKeys) -> Ciphertext:
    return relinearize_floor(ctx, ctx.multiply(a, b), rk)

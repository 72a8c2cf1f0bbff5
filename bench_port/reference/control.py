"""The control that the comparison of ``bench_port/check.py`` must fail.

The configurations state no precision: their arithmetic is exact, and the
guarantee they state is that every validator produces the canonical bytes
(SEAL's conventions, as ``golden.py`` defines them).  The control breaks that
guarantee with the step that would tempt a faster multiply: relinearization
divides by the special prime P rounding down instead of to the nearest
integer, dropping the P/2 correction.  Its results still decrypt to the right
plaintexts, since the error it adds is below 1 a coefficient, but most of
their words differ from the canonical ones.

The cipher∘plain ops have a control each, of the same kind: their results
still decrypt right, but their words are not the canonical ones.
``add_plain``, ``sub_plain`` and ``plain_sub`` scale the plaintext by q/t
rounding down (``_scale_plain`` without its t // 2), which changes the first
component wherever the rounding went up; ``mul_plain`` lifts the plaintext
centred (a coefficient m >= t/2 as p - (t - m)), which changes every word
of the product.
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


def scale_plain_floor(ctx: BfvContext, plain: np.ndarray) -> np.ndarray:
    """``BfvContext._scale_plain`` rounding q*m/t down: without t // 2."""
    m = np.asarray(plain, dtype=np.uint64)
    fix = np.uint64(ctx.q_mod_t) * m // np.uint64(ctx.t)
    out = np.empty((ctx.k, m.shape[-1]), dtype=np.uint64)
    for j, p in enumerate(ctx.q_mods):
        out[j] = addmod(mulmod(np.uint64(ctx.delta_mod_q[j]), m, p), fix, p)
    return out


def add_sub_plain_floor(ctx: BfvContext, op: str, a: Ciphertext,
                        plain: np.ndarray) -> Ciphertext:
    """``add_plain``, ``sub_plain`` or ``plain_sub`` on the plaintext scaled
    by ``scale_plain_floor``."""
    out = a.data.copy()
    dm = scale_plain_floor(ctx, plain)
    fn = addmod if op == "add_plain" else submod
    for j, p in enumerate(ctx.q_mods):
        out[0, j] = fn(out[0, j], dm[j], p)
    ct = Ciphertext(ctx.params, out)
    return ctx.negate(ct) if op == "plain_sub" else ct


def mul_plain_centred(ctx: BfvContext, a: Ciphertext,
                      plain: np.ndarray) -> Ciphertext:
    """``mul_plain`` with the plaintext lifted centred: a coefficient
    m >= t/2 lifted as p - (t - m), not as m."""
    m = np.asarray(plain, dtype=np.uint64)
    t = np.uint64(ctx.t)
    upper = m >= (t + np.uint64(1)) // np.uint64(2)
    out = np.empty_like(a.data)
    for j, p in enumerate(ctx.q_mods):
        tb = ctx.tables[p]
        lifted = np.where(upper, np.uint64(p) - (t - m), m)
        m_ntt = ntt(lifted, tb)
        for comp in range(a.size):
            out[comp, j] = intt(mulmod(ntt(a.data[comp, j].copy(), tb),
                                       m_ntt, p), tb)
    return Ciphertext(ctx.params, out)

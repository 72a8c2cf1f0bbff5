"""Hand-placed inputs that force the branches of the tail segments.

Random residues reach both sides of every comparison with high probability,
but not the boundary values.  These helpers overwrite the first coefficient
positions of row 0 of a random input so that the m_tilde correction ``r`` of
``to_bsk_ext`` and the Shenoy-Kumaresan ``alpha`` of ``floor_sk`` take chosen
values: both sides of each centring threshold, the extremes, and (where the
moduli allow it) the ``alpha`` whose reduced negation is zero.  Used by the
CPU tests and by the on-card comparison of each kernel with its plain version
(``chip_smoke.py``), which may import nothing but this package; nothing that
runs at runtime in the package imports this module.
"""
from __future__ import annotations

import numpy as np

from ..bfv.golden import BfvContext


def r_targets(ctx: BfvContext):
    mt = ctx.m_tilde
    return [0, 1, mt // 2, mt // 2 + 1, mt - 1]


def alpha_targets(ctx: BfvContext):
    msk = ctx.m_sk
    out = [0, 1, msk // 2, msk // 2 + 1, msk - 1]
    # m_sk - alpha == q_i in the negative branch: the negation must give 0
    out += [msk - p for p in ctx.q_mods if msk - p >= msk // 2 + 1]
    return out


def place_r_cases(a: np.ndarray, ctx: BfvContext) -> np.ndarray:
    """a: uint64 (rows, k, n) input of to_bsk_ext.  Returns a copy whose row 0
    has r == r_targets(ctx)[j] at coefficient position j."""
    a = a.copy()
    mt, q0 = ctx.m_tilde, ctx.q_mods[0]
    mt_qhinv0 = ctx.mtilde_mod_q[0] * ctx.q_hat_inv[0] % q0
    # r = y_0 * (q_hat_0 mod mt) * (-q^-1 mod mt) mod mt when y_i = 0, i > 0
    unit = (ctx.q_hat[0] % mt) * ctx.neg_inv_q_mod_mtilde % mt
    for j, r in enumerate(r_targets(ctx)):
        y0 = r * pow(unit, -1, mt) % mt
        a[0, :, j] = 0
        a[0, 0, j] = y0 * pow(mt_qhinv0, -1, q0) % q0
    return a


def place_alpha_cases(tq: np.ndarray, ctx: BfvContext) -> np.ndarray:
    """tq: uint64 (rows, nb, n) input of floor_sk.  Returns a copy whose row 0
    has alpha == alpha_targets(ctx)[j] at coefficient position j."""
    tq = tq.copy()
    msk = ctx.m_sk
    for j, alpha in enumerate(alpha_targets(ctx)):
        # all other limbs zero: alpha = -fl_msk / prod(B), fl_msk = x_msk / q
        fl_msk = (-alpha * ctx.prod_B) % msk
        tq[0, :, j] = 0
        tq[0, -1, j] = fl_msk * ctx.q % msk
    return tq

"""Exact multiword CRT scale-and-round for device decryption.

Counterpart of ``fhe_precompiles_tpu/ops/wide.py``.  Computes, per
coefficient, ``m = floor((t*x + q//2) / q) mod t`` where
``x = (sum_j y_j * q_hat_j) mod q`` and ``y_j = |dot_j * q_hat_inv_j|_{q_j}``:
the exact semantics of ``bfv/golden.py::_message_from_dot``, on every
wire-valid input, rounding-boundary dots included (decrypt bytes are part of
the consensus contract).

Everything is 32-bit-limb multiword arithmetic in ``torch.int64`` lanes, as
plain torch ops (the reference computes it outside any kernel too).  One
thing differs from unsigned lanes: a product of two 32-bit limbs can pass
2**63.  int64 multiplication wraps, so the low 64 bits are still right, but
``>>`` on int64 is an arithmetic shift and would smear the sign over the high
limb.  ``_mul_acc_const`` masks after the shift.  Every other intermediate
(slot sums, carries, borrows) stays far below 2**63.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_B32 = 1 << 32


def _int_limbs(v: int, count: int) -> list:
    """Little-endian 32-bit limbs of a nonnegative Python int."""
    assert 0 <= v < (1 << (32 * count)), (v, count)
    return [(v >> (32 * i)) & _M32 for i in range(count)]


def _carry(slots: list) -> list:
    """Normalise accumulated slots to canonical (< 2**32) limbs.  The carry
    out of the top slot is zero: callers size the slot count from exact
    host-side bounds (asserted in ``ExactScaleRound.__init__``)."""
    out = []
    carry = None
    for s in slots:
        cur = s if carry is None else s + carry
        out.append(cur & _M32)
        carry = cur >> 32
    return out


def _mul_acc_const(slots: list, x_limbs: list, c_limbs: list,
                   zero: torch.Tensor) -> None:
    """slots += x * c (schoolbook; x limbs are tensors < 2**32, c limbs are
    Python ints).  Empty slots are filled with `zero`."""
    W = len(slots)
    for a, xa in enumerate(x_limbs):
        for b, cb in enumerate(c_limbs):
            if cb == 0:
                continue
            p = xa * cb                       # wraps past 2**63: low 64 bits
            lo, hi = p & _M32, (p >> 32) & _M32
            if a + b < W:
                slots[a + b] = lo if slots[a + b] is None else slots[a + b] + lo
            if a + b + 1 < W:
                s = slots[a + b + 1]
                slots[a + b + 1] = hi if s is None else s + hi
    for i in range(W):
        if slots[i] is None:
            slots[i] = zero


def _sub_borrow(x: list, y: list):
    """(x - y) limbs with the final borrow: returns (diff, x >= y).  `y` may
    hold tensors or Python ints."""
    diff = []
    borrow = 0
    for xi, yi in zip(x, y):
        tmp = xi + _B32 - yi - borrow
        diff.append(tmp & _M32)
        borrow = (tmp >> 32) ^ 1
    return diff, borrow == 0


class ExactScaleRound:
    """Host-precomputed constants and the exact rounding on int64 tensors.

    ``__call__(y)`` maps canonical residues y: (..., k, n) (each limb row
    < q_j) to the plaintext polynomial m: (..., n) in [0, t).  Bit-identical
    to ``golden._message_from_dot`` by construction."""

    def __init__(self, q_mods, t: int):
        q_mods = [int(p) for p in q_mods]
        t = int(t)
        assert 2 <= t < (1 << 32), "plain modulus must fit one 32-bit limb"
        k = len(q_mods)
        q = math.prod(q_mods)
        self.k, self.t = k, t

        q_hat = [q // p for p in q_mods]
        # accumulation bound: S = sum_j y_j * q_hat_j < k * q
        s_max = sum((p - 1) * h for p, h in zip(q_mods, q_hat))
        self.WS = max((s_max.bit_length() + 31) // 32,
                      # hi halves land one slot above the top product limb
                      2 + max((h.bit_length() + 31) // 32 for h in q_hat))
        assert s_max < 1 << (32 * self.WS)
        self.q_hat_limbs = [_int_limbs(h, self.WS) for h in q_hat]
        self.q_limbs_S = _int_limbs(q, self.WS)
        self.n_csub = k - 1                     # S < k*q

        # z = t*x + q//2 with x < q
        z_max = t * (q - 1) + q // 2
        self.WZ = max((z_max.bit_length() + 31) // 32,
                      (q.bit_length() + 31) // 32 + 1)
        assert z_max < 1 << (32 * self.WZ)
        self.t_limbs = _int_limbs(t, 1)
        self.h_limbs = _int_limbs(q // 2, self.WZ)
        self.q_limbs_Z = _int_limbs(q, self.WZ)

        # Barrett: m_est = floor(z * mu / 2**s), s >= bits(z_max) + 1
        # => m_est in {m_true - 1, m_true}; one conditional +1 corrects.
        self.sl = (z_max.bit_length() + 1 + 31) // 32
        mu = (1 << (32 * self.sl)) // q
        self.mu_limbs = _int_limbs(mu, (mu.bit_length() + 31) // 32)
        # product slots: limbs [0, sl+1] must be right => W = sl + 2
        self.WP = self.sl + 2

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        k, t = self.k, self.t
        zero = torch.zeros_like(y[..., 0, :])
        # split residues into 32-bit limb pairs
        ys = [(y[..., j, :] & _M32, y[..., j, :] >> 32) for j in range(k)]

        # S = sum_j y_j * q_hat_j
        slots = [None] * self.WS
        for j in range(k):
            _mul_acc_const(slots, list(ys[j]), self.q_hat_limbs[j], zero)
        S = _carry(slots)
        # x = S mod q via at most k-1 conditional subtracts
        for _ in range(self.n_csub):
            diff, geq = _sub_borrow(S, self.q_limbs_S)
            S = [torch.where(geq, d, s) for d, s in zip(diff, S)]
        x = S[:self.WZ] + [zero] * max(0, self.WZ - len(S))

        # z = t*x + q//2
        slots = [None] * self.WZ
        _mul_acc_const(slots, x, self.t_limbs, zero)
        for i, h in enumerate(self.h_limbs):
            if h:
                slots[i] = slots[i] + h
        z = _carry(slots)

        # m_est = floor(z * mu / 2**(32*sl))
        slots = [None] * self.WP
        _mul_acc_const(slots, z, self.mu_limbs, zero)
        prod = _carry(slots)
        m = prod[self.sl] | (prod[self.sl + 1] << 32)

        # correct: r = z - m*q; if r >= q then m += 1  (m <= t < 2**32)
        slots = [None] * self.WZ
        _mul_acc_const(slots, [m & _M32, m >> 32], self.q_limbs_Z, zero)
        w = _carry(slots)
        r, _ = _sub_borrow(z, w)
        _, r_geq_q = _sub_borrow(r, self.q_limbs_Z)
        m = torch.where(r_geq_q, m + 1, m)

        # m <= t exactly once (x in the top sliver of [0, q)); reduce mod t
        return torch.where(m >= t, m - t, m)

"""Published peaks of one NVIDIA H100 SXM, and the operation costs that the
roofline metrics count in.

Memory: 3.35 TB/s.  The port's kernels do 64-bit integer arithmetic on the
32-bit integer pipe, which has half the lanes of the float32 pipe (67
TFLOP/s = 33.5e12 multiply-adds a second): 16.75e12 32-bit integer
multiply-adds a second.  The high half of a 64 x 64-bit product takes four of
them, the low half three.  The NTT kernels and ``floor_sk`` form their 40-bit
Shoup products on the FP64 pipe, four multiply-adds each (q = a * ws40 / 2^40
rounded down, h = a * w, its error a * w - h, h - q * p); FP64 outside the
tensor cores runs at half the float32 rate: 16.75e12 multiply-adds a second.
The rates assume the card's full power limit of 700 W; the harness prints
the card's limit beside every share.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 16.75e12
PEAK_FP64_FMA_PER_S = 16.75e12

MULHI, MULLO = 4, 3
SHOUP = MULHI + 2 * MULLO         # hi(a * ws), a * w, q * p
BARRETT = MULHI + MULLO           # hi(x * mu), q * p
# general product kept lazy: hi(a * b), a * b, hi * (2^64 mod p), one Barrett
# step (2^64 mod p is the same for a whole launch and is not counted)
MUL_LAZY = MULHI + 2 * MULLO + BARRETT
MULMOD = MUL_LAZY + BARRETT
SHOUP40_FMAS = 4

WORD_BYTES = 8


def bound_s(nbytes: float, imads: float = 0.0, fp64_fmas: float = 0.0
            ) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their pipe's rate (the integer and
    the FP64 pipes run side by side, so the larger of the two)."""
    return max(nbytes / PEAK_BYTES_PER_S, imads / PEAK_IMAD_PER_S,
               fp64_fmas / PEAK_FP64_FMA_PER_S)

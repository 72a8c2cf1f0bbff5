"""Four-step negacyclic NTT on digit matrix products: the tables, two CUDA
kernels, their wrappers and their plain PyTorch versions.

The port's copy of ``fhe_precompiles_tpu/ops/mxu_ntt.py`` (tables and plain
transform) and the counterpart of ``fhe_precompiles_tpu/ops/pallas_ntt.py``
(kernels).  The bit-reversed NTT of size n = R * C factors exactly as

    NTT(x)  = (T (*) (A @ M)) @ B0^T          M = x.reshape(R, C)
    iNTT(y) = A' @ (T' (*) (N @ B0'^T))       N = y.reshape(R, C)

with A (R x R) the cross-row stages, B0 (C x C) the in-row stages and T an
(R x C) twiddle grid, all derived numerically per modulus from the golden
stage loop; n^-1, times the caller's per-limb factor, is folded into A'.
Every matrix entry (< p < 2^37) is split into NDIG = 5 base-256 digits, each
product into 25 digit-pair products that are summed exactly, and the sums
recombine mod p.  All of it is exact integer arithmetic, so the transform
gives the bytes of ``ops/ntt.py`` (and of the golden model).

  ==============  ===============================================  ===========
  wrapper         replaces (fhe_precompiles_tpu/ops/pallas_ntt.py)  plain
  ==============  ===============================================  ===========
  ntt             PallasNtt._fused_call / _fused_kernel_factory     ntt_plain
                  (inverse=False)
  intt            same, inverse=True                                intt_plain
  phase           PallasNtt._phase / _phase_kernel_factory          phase_plain
  ==============  ===============================================  ===========

``ntt`` / ``intt`` / ``phase`` take the plain version only for a tensor that
lies on the CPU.  For a CUDA tensor they launch the kernel of
``csrc/four_step.cu`` on PyTorch's current stream (no synchronise; the output
comes from ``torch.empty``, or is the caller's ``out=``) or raise; nothing
falls back.  Each adds one to
``launch_counts[name]`` where it launches.  On the card the digit-pair
products run on the integer tensor cores (u8 x u8 -> s32).

The plain versions take the digit-pair products with ``torch.matmul`` in
float64, where every sum (< 2^26) is exact.  Nothing on the card's path calls
them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..bfv.modmath import addmod as np_addmod
from ..bfv.modmath import get_ntt_tables, invmod
from ..bfv.modmath import mulmod as np_mulmod
from ..bfv.modmath import submod as np_submod
from . import build
from .modmath import barrett_mu, mulmod, shoup40_precompute, shoup_precompute
from .ntt import _check_input, _group_stride, _into, _output

NDIG = 5                       # base-256 digits of a residue below 2^40
KERNEL_SIDES = (16, 32, 64, 128)   # R and C the kernels take
DEFAULT_C = 64                 # the row length C of FourStepNtt's split
# csrc/four_step.cu's shared-memory budget for kernels 8 and 9
# (FS_MAX_SMEM, FS_BARRIER_BYTES, FS_MAX_ROWS); ``kernel_fit`` and
# ``phase_fit`` mirror ``four_step_fit`` and ``phase_fit`` there, and the
# wrappers hold them together at first launch
MAX_SMEM, BARRIER_BYTES, MAX_ROWS = 232448, 16, 4
# an SM's shared memory and what the card keeps of it for each block
# (FS_SM_SMEM, FS_BLOCK_RESERVED): kernel 9 fits two blocks an SM where it
# can
SM_SMEM, BLOCK_RESERVED = 233472, 1024
PHASE_MODES = ("none", "pre", "post")

KERNEL_NAMES = ("four_step_ntt", "four_step_intt", "four_step_phase")
launch_counts = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ======================================================================
# tables (host numpy, then tensors on the caller's device)
# ======================================================================
def _apply_stages(a: np.ndarray, tb, m_start: int, m_end: int,
                  inverse: bool) -> np.ndarray:
    """Golden stage loop over a batch (B, n) for stages m_start..m_end."""
    p = np.uint64(tb.p)
    n = tb.n
    a = a.copy()
    B = a.shape[0]
    m = m_start
    if not inverse:
        while m <= m_end:
            v = a.reshape(B, m, 2, n // (2 * m))
            w = tb.root_powers[m:2 * m].reshape(m, 1)
            lo = v[:, :, 0, :].copy()
            hi = np_mulmod(v[:, :, 1, :], w, p)
            v[:, :, 0, :] = np_addmod(lo, hi, p)
            v[:, :, 1, :] = np_submod(lo, hi, p)
            m *= 2
    else:
        while m >= m_end:
            v = a.reshape(B, m, 2, n // (2 * m))
            w = tb.inv_root_powers[m:2 * m].reshape(m, 1)
            lo = v[:, :, 0, :].copy()
            hi = v[:, :, 1, :].copy()
            v[:, :, 0, :] = np_addmod(lo, hi, p)
            v[:, :, 1, :] = np_mulmod(np_submod(lo, hi, p), w, p)
            m //= 2
    return a


def _ratio_rows(num: np.ndarray, den: int, p: int) -> np.ndarray:
    return (num.astype(object) * invmod(den, p) % p).astype(np.uint64)


@functools.lru_cache(maxsize=None)
def _derive_matrices(p: int, n: int, C: int):
    """(A, B0, T, Ai, B0i, Ti) mod p for the R * C split, derived
    from the golden stage loop; Ai carries n^-1.  Cached: callers must not
    write into the arrays."""
    R = n // C
    tb = get_ntt_tables(p, n)

    # forward: the cross-row stages (m = 1 .. R/2) act as one column
    # transform A; the in-row stages (m = R .. n/2) act on row r as B_r
    basis_rows = np.zeros((R, n), dtype=np.uint64)
    basis_rows[np.arange(R), np.arange(R) * C] = 1
    A = _apply_stages(basis_rows, tb, 1, R // 2, False
                      ).reshape(R, R, C)[:, :, 0].T.copy()     # A[i, r]
    basis_cols = np.zeros((C, n), dtype=np.uint64)
    for c in range(C):
        basis_cols[c, np.arange(R) * C + c] = 1
    Ball = _apply_stages(basis_cols, tb, R, n // 2, False
                         ).reshape(C, R, C)                    # [c, r, i]
    B0 = Ball[:, 0, :].T.copy()                                 # B0[i, c]
    # T[r, c] = B_r[i0, c] / B_0[i0, c] for any i0 with B_0[i0, c] != 0
    T = np.empty((R, C), dtype=np.uint64)
    for c in range(C):
        i0 = int(np.nonzero(B0[:, c])[0][0])
        T[:, c] = _ratio_rows(Ball[c, :, i0], int(B0[i0, c]), p)
    assert np.all(T[0] == 1)

    # inverse: in-row stages first (m = n/2 .. R), then cross-row
    Bialla = _apply_stages(basis_cols, tb, n // 2, R, True
                           ).reshape(C, R, C)          # [c, r, i] = B'_r[i, c]
    B0i = Bialla[:, 0, :].T.copy()                                # B'_0[i, c]

    # diag-left: B'_r = diag(e_r) B'_0, the grid on the output side.  It
    # holds for every stack the engine uses (the JAX package also tries the
    # input side; the kernels take this form only)
    Ti = np.empty((R, C), dtype=np.uint64)
    for i in range(C):
        c0 = int(np.nonzero(B0i[i, :])[0][0])
        Ti[:, i] = _ratio_rows(Bialla[c0, :, i], int(B0i[i, c0]), p)
    if not all(np.array_equal(
            Bialla[:, r, :].T,
            (B0i.astype(object) * Ti[r][:, None].astype(object) % p
             ).astype(np.uint64)) for r in (1, R // 2, R - 1)):
        raise ValueError(f"four-step NTT: the inverse of n = {n}, C = {C} "
                         f"mod {p} does not factor with the grid on its "
                         "output side")

    Ai = _apply_stages(basis_rows, tb, R // 2, 1, True
                       ).reshape(R, R, C)[:, :, 0].T.copy()
    Ai = (Ai.astype(object) * int(tb.n_inv) % p).astype(np.uint64)
    return A, B0, T, Ai, B0i, Ti


def _digits(m: np.ndarray) -> np.ndarray:
    """(X, Y) uint64 -> (NDIG, X, Y) uint8 digit planes, low digit first."""
    return np.stack([((m >> np.uint64(8 * d)) & np.uint64(0xFF)
                      ).astype(np.uint8) for d in range(NDIG)])


def wgmma_offset(row, k, K: int):
    """Byte offset of element (row, k) of a K-major operand of depth K in
    kernel 8's shared memory, wgmma's canonical layout without swizzle: core
    matrices of 8 rows x 16 bytes, the two 16-byte halves of a 32-deep step
    128 bytes apart, groups of 8 rows 8 * KP bytes apart, KP = max(K, 32).
    Works elementwise on arrays."""
    kp = max(K, 32)
    return (row // 8) * 8 * kp + (k // 16) * 128 + (row % 8) * 16 + k % 16


def wgmma_weight_layout(K: int) -> np.ndarray:
    """For each byte of one limb's packed weights (NDIG planes of a K x K
    matrix W[d][i][k], rows padded to a multiple of 64, depth to at least
    32, as ``wgmma_offset`` places them), the flat index into the planes it
    holds, or -1 where it holds zero (padding)."""
    mp, kp = -(-K // 64) * 64, max(K, 32)
    d, i, k = np.meshgrid(np.arange(NDIG), np.arange(mp), np.arange(kp),
                          indexing="ij")
    out = np.full(NDIG * mp * kp, -1, dtype=np.int64)
    at = d * mp * kp + wgmma_offset(i, k, K)
    inside = (i < K) & (k < K)
    out[at[inside]] = ((d * K + i) * K + k)[inside]
    return out


def weight_bytes(K: int) -> int:
    """Bytes of one limb's packed weights at side K: NDIG planes of
    64 * ceil(K / 64) rows of depth max(K, 32)."""
    return NDIG * (-(-K // 64) * 64) * max(K, 32)


@functools.lru_cache(maxsize=None)
def _unpack_index(K: int) -> np.ndarray:
    """For each entry of the (NDIG, K, K) planes, its byte in the packed
    weights."""
    idx = wgmma_weight_layout(K)
    src = np.empty(NDIG * K * K, dtype=np.int64)
    src[idx[idx >= 0]] = np.nonzero(idx >= 0)[0]
    return src


def unpack_wgmma(packed: torch.Tensor, K: int) -> torch.Tensor:
    """(L, weight_bytes(K)) packed weights -> (L, NDIG, K, K) uint8
    planes W[d][i][k], read back through ``wgmma_weight_layout``."""
    if packed.dim() != 2 or packed.shape[1] != weight_bytes(K):
        raise ValueError(f"packed weights of side {K} are (L, "
                         f"{weight_bytes(K)}), got {tuple(packed.shape)}")
    src = torch.from_numpy(_unpack_index(K)).to(packed.device)
    return packed[:, src].reshape(-1, NDIG, K, K)


def pack_wgmma(planes: np.ndarray) -> np.ndarray:
    """(L, NDIG, K, K) uint8 planes -> (L, bytes) in
    ``wgmma_weight_layout``, contiguous."""
    L, _, K, _ = planes.shape
    idx = wgmma_weight_layout(K)
    flat = planes.reshape(L, -1)
    return np.ascontiguousarray(
        np.where(idx >= 0, flat[:, np.maximum(idx, 0)], 0), dtype=np.uint8)


def kernel_fit(R: int, C: int):
    """(rows a batch, staged, shared-memory bytes) of kernel 8 at sides R, C,
    as ``four_step_fit`` in csrc/four_step.cu: both weight matrices
    (``len(wgmma_weight_layout(K))`` bytes each) and, per row, the two
    operands' digit planes (N >= 32 columns of depth max(K, 32)) and an
    8n-byte staging buffer; else one row unstaged; (0, 0, 0) where not even
    that fits (R = C = 128) or a side is not one the kernel takes."""
    if R not in KERNEL_SIDES or C not in KERNEL_SIDES:
        return 0, 0, 0
    fixed = BARRIER_BYTES + weight_bytes(R) + weight_bytes(C)
    slot = NDIG * (max(C, 32) * max(R, 32) + max(R, 32) * max(C, 32))
    rows = min(MAX_ROWS, (MAX_SMEM - fixed) // (slot + 8 * R * C))
    if rows >= 1:
        return rows, 1, fixed + rows * (slot + 8 * R * C)
    if fixed + slot <= MAX_SMEM:
        return 1, 0, fixed + slot
    return 0, 0, 0


def phase_fit(K: int, J: int):
    """(rows a batch, grid staged, input staged, shared-memory bytes) of
    kernel 9 at sides K, J, as ``phase_fit`` in csrc/four_step.cu: in the
    shared memory of one of two blocks an SM, else of one block; with the
    limb's grid words (8KJ bytes), else without; with an 8KJ-byte input
    staging buffer a row, else without; beside the weights
    (``weight_bytes(K)``), as many rows as fit (up to MAX_ROWS), each with
    its operand's digit planes (max(J, 32) columns of depth max(K, 32)): the
    first of these that holds a row.  (0, 0, 0, 0) for a side the kernel
    does not take."""
    if K not in KERNEL_SIDES or J not in KERNEL_SIDES:
        return 0, 0, 0, 0
    words = 8 * K * J
    for blocks in (2, 1):
        budget = min(MAX_SMEM, SM_SMEM // blocks - BLOCK_RESERVED)
        for grid_staged in (1, 0):
            for in_staged in (1, 0):
                fixed = BARRIER_BYTES + weight_bytes(K) + grid_staged * words
                row = NDIG * max(J, 32) * max(K, 32) + in_staged * words
                rows = min(MAX_ROWS, (budget - fixed) // row)
                if rows >= 1:
                    return rows, grid_staged, in_staged, fixed + rows * row
    return 0, 0, 0, 0


@dataclasses.dataclass(frozen=True)
class MxuNttTables:
    """Four-step tables for a stack of L moduli, tensors on one device.

    The fields down to ``pow_dig_shoup`` are those of the JAX package's
    ``MxuNttTables`` (digit planes in uint8 where it holds bf16; words as
    int64 storage of uint64).  The rest are the kernels' layouts of the same
    numbers."""

    n: int
    R: int
    C: int
    p: torch.Tensor              # (L, 1)
    mu: torch.Tensor             # (L, 1) floor(2^64 / p)
    A_dig: torch.Tensor          # (L, NDIG, R, R) uint8, A[i, r]
    B0T_dig: torch.Tensor        # (L, NDIG, C, C) uint8, B0[i, c] at [c, i]
    T: torch.Tensor              # (L, R, C)
    T_shoup: torch.Tensor
    Ai_dig: torch.Tensor         # (L, NDIG, R, R), n^-1 * factor folded in
    B0iT_dig: torch.Tensor       # (L, NDIG, C, C)
    Ti: torch.Tensor             # (L, R, C)
    Ti_shoup: torch.Tensor
    diag_left: bool              # always True: the form the port takes
    pow_dig: torch.Tensor        # (L, 2*NDIG-1, 1, 1): 256^s mod p
    pow_dig_shoup: torch.Tensor
    # the kernels' layouts: the weights in ``wgmma_weight_layout``,
    # (L, weight_bytes) uint8; the grids T and Ti also transposed (the
    # two-launch form's "pre" and "post" grids; Ti's is kernel 8's inverse
    # grid), kernel 8's grids with their beta = 40 Shoup words
    # floor(w * 2^40 / p); `fold_scalars` (L, 4): p, c32 = 2^32 mod p,
    # floor(c32 * 2^52 / p), floor(2^52 / p)
    A_wg: torch.Tensor
    B0_wg: torch.Tensor
    Ai_wg: torch.Tensor
    B0i_wg: torch.Tensor
    T_shoup40: torch.Tensor      # (L, R, C)
    TT: torch.Tensor             # (L, C, R) = T transposed
    TiT: torch.Tensor            # (L, C, R) = Ti transposed
    TiT_shoup40: torch.Tensor
    fold_scalars: torch.Tensor


def _dev(arr, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint64).view(np.int64)).to(device)


def build_mxu_tables(moduli: Sequence[int], n: int, device,
                     C: int = DEFAULT_C,
                     n_inv_factors: Optional[Sequence[int]] = None
                     ) -> MxuNttTables:
    """Tables on `device`, which the caller names (there is no default).
    n_inv_factors: optional per-limb constants that multiply A' before its
    digit split, so that the inverse returns ``factor * x`` (the engine folds
    t and t * q_hat_inv there, as it does into the butterfly's n^-1)."""
    moduli = [int(p) for p in moduli]
    R = n // C
    if R * C != n or R < 2 or C < 2:
        raise ValueError(f"four-step NTT: n = {n} is not R * C with C = {C} "
                         "and R, C >= 2")
    if max(moduli) >= 1 << 37:
        raise ValueError("four-step NTT: moduli must be below 2^37")
    mats = [_derive_matrices(p, n, C) for p in moduli]
    factors = n_inv_factors if n_inv_factors is not None else [1] * len(moduli)
    Ai = [(m[3].astype(object) * (int(f) % p) % p).astype(np.uint64)
          for m, f, p in zip(mats, factors, moduli)]
    p_col = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
    grid = p_col[:, :, None]

    def stack(i):
        return np.stack([m[i] for m in mats])

    def digit_planes(mats_):
        return np.stack([_digits(m) for m in mats_])

    def digits(mats_):
        return torch.from_numpy(
            np.ascontiguousarray(digit_planes(mats_))).to(device)

    def packed(mats_):
        return torch.from_numpy(pack_wgmma(digit_planes(mats_))).to(device)

    T, Ti = stack(2), stack(5)
    T_s, Ti_s = shoup_precompute(T, grid), shoup_precompute(Ti, grid)
    pows = np.array([[pow(256, s, p) for s in range(2 * NDIG - 1)]
                     for p in moduli], dtype=np.uint64)[..., None, None]
    pows_s = shoup_precompute(pows, p_col[:, :, None, None])
    fold_scalars = np.array([[p, (1 << 32) % p, (((1 << 32) % p) << 52) // p,
                              (1 << 52) // p] for p in moduli],
                            dtype=np.uint64)
    TiT = Ti.transpose(0, 2, 1)
    return MxuNttTables(
        n=n, R=R, C=C, p=_dev(p_col, device),
        mu=_dev(barrett_mu(p_col), device),
        A_dig=digits([m[0] for m in mats]),
        B0T_dig=digits([m[1].T for m in mats]),
        T=_dev(T, device), T_shoup=_dev(T_s, device),
        Ai_dig=digits(Ai), B0iT_dig=digits([m[4].T for m in mats]),
        Ti=_dev(Ti, device), Ti_shoup=_dev(Ti_s, device),
        diag_left=True,
        pow_dig=_dev(pows, device), pow_dig_shoup=_dev(pows_s, device),
        A_wg=packed([m[0] for m in mats]), B0_wg=packed([m[1] for m in mats]),
        Ai_wg=packed(Ai), B0i_wg=packed([m[4] for m in mats]),
        T_shoup40=_dev(shoup40_precompute(T, grid), device),
        TT=_dev(T.transpose(0, 2, 1), device), TiT=_dev(TiT, device),
        TiT_shoup40=_dev(shoup40_precompute(TiT, grid), device),
        fold_scalars=_dev(fold_scalars, device),
    )


# ======================================================================
# plain PyTorch versions
# ======================================================================
def _digit_matmul(w_dig: torch.Tensor, x: torch.Tensor,
                  tb: MxuNttTables) -> torch.Tensor:
    """(W @ X) mod p.  w_dig: (L, NDIG, K, K) uint8; x: (..., L, K, J)
    canonical residues.  The digit-pair products go through float64 matmuls
    (each sum < 2^23 * 5, exact), those of equal digit weight 256^s summed,
    and the nine sums recombine mod p."""
    L, _, K, _ = w_dig.shape
    w = w_dig.to(torch.float64).reshape(L, NDIG * K, K)
    sums = [None] * (2 * NDIG - 1)
    for db in range(NDIG):
        plane = ((x >> (8 * db)) & 0xFF).to(torch.float64)
        prod = torch.matmul(w, plane)                 # (..., L, NDIG*K, J)
        for da in range(NDIG):
            piece = prod[..., da * K:(da + 1) * K, :]
            s = da + db
            sums[s] = piece if sums[s] is None else sums[s] + piece
    v_lo = sum(sums[s].to(torch.int64) << (8 * s) for s in range(NDIG))
    v_hi = sum(sums[s].to(torch.int64) << (8 * (s - NDIG))
               for s in range(NDIG, 2 * NDIG - 1))
    p = tb.p[..., None]
    shifted = mulmod(v_hi % p, tb.pow_dig[:, NDIG], p)   # * 2^40 mod p
    return (v_lo % p + shifted) % p


def _digit_matmul_right(x: torch.Tensor, wT_dig: torch.Tensor,
                        tb: MxuNttTables) -> torch.Tensor:
    """(X @ W^T) mod p for wT_dig = digits of W^T."""
    return _digit_matmul(wT_dig.transpose(-1, -2), x.transpose(-1, -2),
                         tb).transpose(-1, -2)


def ntt_plain(x: torch.Tensor, tb: MxuNttTables) -> torch.Tensor:
    """Forward four-step NTT of (..., L, n): natural order in, SEAL's
    bit-reversed order out."""
    lead = x.shape[:-1]
    m = x.reshape(lead + (tb.R, tb.C))
    y = mulmod(_digit_matmul(tb.A_dig, m, tb), tb.T, tb.p[..., None])
    return _digit_matmul_right(y, tb.B0T_dig, tb).reshape(lead + (tb.n,))


def intt_plain(y: torch.Tensor, tb: MxuNttTables) -> torch.Tensor:
    """Inverse four-step NTT of (..., L, n), times n^-1 * factor."""
    lead = y.shape[:-1]
    m = y.reshape(lead + (tb.R, tb.C))
    # B'_r = diag(e_r) B'_0: the grid after the row product
    z = mulmod(_digit_matmul_right(m, tb.B0iT_dig, tb), tb.Ti, tb.p[..., None])
    return _digit_matmul(tb.Ai_dig, z, tb).reshape(lead + (tb.n,))


def _check_mode(mode: str, grid) -> None:
    if mode not in PHASE_MODES:
        raise ValueError(f"phase: mode must be one of {PHASE_MODES}, got "
                         f"{mode!r}")
    if (grid is None) != (mode == "none"):
        raise ValueError(f"phase: mode {mode!r} "
                         + ("takes no grid" if mode == "none"
                            else "needs a grid (its words)"))


def phase_plain(x: torch.Tensor, weights: torch.Tensor, grid, mode: str,
                tb: MxuNttTables) -> torch.Tensor:
    """One digit-matrix product W @ X mod p over (..., L, K, J), with the
    grid's words multiplied in before it ("pre"), after it ("post") or not
    at all ("none").  weights: W packed as the kernel takes it,
    (L, weight_bytes(K)) uint8 (``A_wg``, ``B0_wg``, ``Ai_wg``, ``B0i_wg``),
    read back through ``wgmma_weight_layout``; grid: None or its canonical
    words (L, K, J) (``T``, ``TT``, ``TiT``).  The kernel keeps no Shoup
    words: its grid product is an exact FP64 Barrett product from the word
    alone, so the grid costs 8 bytes a word."""
    _check_mode(mode, grid)
    p = tb.p[..., None]
    if mode == "pre":
        x = mulmod(x, grid, p)
    out = _digit_matmul(unpack_wgmma(weights, x.shape[-2]), x, tb)
    return mulmod(out, grid, p) if mode == "post" else out


# ======================================================================
# kernel wrappers
# ======================================================================
def check_sides(name: str, *sides: int) -> None:
    """The kernels tile each side in 16-row MMA tiles and hold the row in
    one block's shared memory: R and C must be 16, 32, 64 or 128."""
    for side in sides:
        if side not in KERNEL_SIDES:
            raise ValueError(f"{name}: the kernel takes matrix sides "
                             f"{KERNEL_SIDES}, got {side}")


def check_transform_fits(name: str, R: int, C: int) -> None:
    """Kernel 8 takes sides R, C whose weights and one row fit one block's
    shared memory (``kernel_fit``): not R = C = 128."""
    check_sides(name, R, C)
    if kernel_fit(R, C)[0] == 0:
        raise ValueError(f"{name}: the weights and one row of R = {R}, "
                         f"C = {C} do not fit one block's shared memory "
                         f"({MAX_SMEM} bytes)")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_fit_checked = False


def _check_library_fit(lib) -> None:
    """Once: the library's batch geometry is ``kernel_fit``'s and
    ``phase_fit``'s."""
    global _fit_checked
    if _fit_checked:
        return
    for entry, fit in ((lib.fhe_four_step_fit, kernel_fit),
                       (lib.fhe_four_step_phase_fit, phase_fit)):
        for a in KERNEL_SIDES:
            for b in KERNEL_SIDES:
                want = fit(a, b)
                got = (ctypes.c_int * len(want))()
                entry(a, b, got)
                if tuple(got) != want:
                    raise RuntimeError(
                        f"four_step: the library's batch at sides {a}, {b} "
                        f"is {tuple(got)}, {fit.__name__} gives {want}")
    _fit_checked = True


def _launch_transform(name: str, x: torch.Tensor, tb: MxuNttTables,
                      out: Optional[torch.Tensor]) -> torch.Tensor:
    L, n = tb.p.shape[0], tb.n
    _check_input(name, x, tb.p.device, (L, n))
    check_transform_fits(name, tb.R, tb.C)
    inverse = name == "four_step_intt"
    stride = _group_stride(x, name, L, n)
    lib = build.load_library()
    _check_library_fit(lib)
    out = _output(name, out, x.shape, x.device)
    rows = math.prod(x.shape[:-1])
    # the r- and c-product's weights, and the grid in the first product's
    # output order
    if inverse:
        w_r, w_c, grid, grid_s = tb.Ai_wg, tb.B0i_wg, tb.TiT, tb.TiT_shoup40
    else:
        w_r, w_c, grid, grid_s = tb.A_wg, tb.B0_wg, tb.T, tb.T_shoup40
    with torch.cuda.device(x.device):      # the launch goes to x's card
        rc = lib.fhe_four_step_ntt(
            x.data_ptr(), out.data_ptr(), rows, L, tb.R, tb.C, stride,
            tb.fold_scalars.data_ptr(), w_r.data_ptr(), w_c.data_ptr(),
            grid.data_ptr(), grid_s.data_ptr(), int(inverse), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    if rows:                    # the library launches nothing for 0 rows
        launch_counts[name] += 1
    return out


def ntt(x: torch.Tensor, tb: MxuNttTables, *,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward four-step NTT of (..., L, n), both phases in one kernel.
    Kernel for PallasNtt._fused_call (forward)."""
    if x.device.type == "cpu":
        return _into("four_step_ntt", out, ntt_plain(x, tb))
    return _launch_transform("four_step_ntt", x, tb, out)


def intt(x: torch.Tensor, tb: MxuNttTables, *,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse four-step NTT of (..., L, n), times n^-1 * factor, both
    phases in one kernel.  Kernel for PallasNtt._fused_call (inverse)."""
    if x.device.type == "cpu":
        return _into("four_step_intt", out, intt_plain(x, tb))
    return _launch_transform("four_step_intt", x, tb, out)


def phase(x: torch.Tensor, weights: torch.Tensor, grid, mode: str,
          tb: MxuNttTables, *,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One digit-matrix product over (..., L, K, J) with the grid before,
    after or not at all (see ``phase_plain``).  Kernel for
    PallasNtt._phase."""
    name = "four_step_phase"
    if x.device.type == "cpu":
        return _into(name, out, phase_plain(x, weights, grid, mode, tb))
    _check_mode(mode, grid)
    L = tb.p.shape[0]
    if x.dim() < 3:
        raise ValueError(f"{name}: expected (..., {L}, K, J), got "
                         f"{tuple(x.shape)}")
    K, J = x.shape[-2:]
    _check_input(name, x, tb.p.device, (L, K, J))
    check_sides(name, K, J)
    if (weights.dtype != torch.uint8 or weights.device != x.device
            or tuple(weights.shape) != (L, weight_bytes(K))
            or not weights.is_contiguous()):
        raise ValueError(f"{name}: weights must be packed, contiguous uint8 "
                         f"({L}, {weight_bytes(K)}) on {x.device}")
    if grid is not None and (
            grid.dtype != torch.int64 or grid.device != x.device
            or tuple(grid.shape) != (L, K, J) or not grid.is_contiguous()):
        raise ValueError(f"{name}: grid words must be contiguous int64 "
                         f"({L}, {K}, {J}) on {x.device}")
    try:
        flat = x.view(x.shape[:-2] + (K * J,))
    except RuntimeError:
        raise ValueError(f"{name}: each (K, J) matrix must be contiguous, "
                         f"got strides {tuple(x.stride())}") from None
    stride = _group_stride(flat, name, L, K * J)
    lib = build.load_library()
    _check_library_fit(lib)
    out = _output(name, out, x.shape, x.device)
    rows = math.prod(x.shape[:-2])
    with torch.cuda.device(x.device):
        rc = lib.fhe_four_step_phase(
            x.data_ptr(), out.data_ptr(), rows, L, K, J, stride,
            tb.fold_scalars.data_ptr(), weights.data_ptr(),
            None if grid is None else grid.data_ptr(),
            PHASE_MODES.index(mode), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    if rows:                    # the library launches nothing for 0 rows
        launch_counts[name] += 1
    return out


def _matrices(x: torch.Tensor, tb: MxuNttTables) -> torch.Tensor:
    """(..., L, n) as (..., L, R, C) without a copy (a view, or an error)."""
    return x.view(x.shape[:-1] + (tb.R, tb.C))


def ntt_two_launch(x: torch.Tensor, tb: MxuNttTables) -> torch.Tensor:
    """Forward transform as PallasNtt._call with fused=False: the r-product
    ("none"), a transpose, the c-product with the grid before it ("pre"), a
    transpose back.  The transposes are torch copies, as the reference
    leaves them to XLA."""
    y = phase(_matrices(x, tb), tb.A_wg, None, "none", tb)
    zt = phase(y.transpose(-1, -2).contiguous(), tb.B0_wg, tb.TT, "pre",
               tb)
    return zt.transpose(-1, -2).reshape(x.shape)


def intt_two_launch(x: torch.Tensor, tb: MxuNttTables) -> torch.Tensor:
    """Inverse transform in two launches: the c-product with the grid after
    it ("post") on the transposed matrices, a transpose, the r-product."""
    zt = phase(_matrices(x, tb).transpose(-1, -2).contiguous(), tb.B0i_wg,
               tb.TiT, "post", tb)
    out = phase(zt.transpose(-1, -2).contiguous(), tb.Ai_wg, None, "none",
                tb)
    return out.view(x.shape)


class FourStepNtt:
    """ntt / intt over one stack of moduli with the four-step kernels, as
    ``PallasNtt``: ``fused=True`` runs both products in one launch (kernel
    8), ``fused=False`` in two launches of kernel 9 with torch transposes
    between them."""

    def __init__(self, moduli: Sequence[int], n: int, device,
                 C: int = DEFAULT_C,
                 fused: bool = True,
                 n_inv_factors: Optional[Sequence[int]] = None):
        self.tables = build_mxu_tables(moduli, n, device, C, n_inv_factors)
        self.fused = fused

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return (ntt if self.fused else ntt_two_launch)(x, self.tables)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return (intt if self.fused else intt_two_launch)(x, self.tables)

"""The five BEHZ tail segments of multiply + relinearize: CUDA kernels, their
wrappers and their plain PyTorch versions.

Each segment is the pointwise work between two NTTs of the pipeline in
``ops/behz.py`` and replaces one Pallas TPU kernel of
``fhe_precompiles_tpu/ops/pallas_tail.py``:

  ==============  ===========================  ==========================
  wrapper         replaces (PairTailPallas.)   shapes
  ==============  ===========================  ==========================
  to_bsk_ext      to_bsk_ext / _to_bsk_kern    (..., k, n) -> (..., nb, n)
  dyadic          dyadic / _dyadic_kern        (B,2,nb,n)^2 -> (B,3,nb,n)
  floor_sk        floor_sk / _floor_sk_kern    (..., nb, n) -> (..., k, n)
  relin_dot       relin_dot / _relin_dot_kern  (B,k,kk,n) x (k,2,kk,n)
                                               -> (B,2,kk,n)
  mod_down        mod_down / _mod_down_kern    (B,2,kk,n) + (B,2,k,n)
                                               -> (B,2,k,n)
  ==============  ===========================  ==========================

Each kernel in ``csrc/tail.cu`` reads each input word once and writes each
output word once.  Four of them are one thread per coefficient position with
the limb loops in registers; ``floor_sk``, which does the most arithmetic a
word, has one instance per limb-count pair, forms its products on the FP64
pipe from the folded factors that ``TailConstants`` derives, and takes two
positions a thread; see the notes there.

A wrapper takes the plain version only for a tensor that lies on the CPU.
For a CUDA tensor it launches its kernel on PyTorch's current stream (no
synchronise; outputs come from ``torch.empty``) or raises; nothing falls
back.  Each wrapper adds one to ``launch_counts[name]`` where it launches.

The plain versions are built from ``ops/modmath.py`` on int64 tensors and
follow the contraction helpers of ``fhe_precompiles_tpu/ops/behz_pair.py``
(``_fastbconv``, ``to_bsk``, ``fastbconv_sk``); every result is the canonical
residue of exact arithmetic, so they agree with the kernels bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..bfv.golden import BfvContext
from . import build
from .modmath import (addmod, barrett_mu, mulmod, negmod, shoup40_precompute,
                      shoup_precompute, submod)

# fixed limb capacities of the kernels' parameter struct (csrc/tail.cu)
MAX_K, MAX_BSK, MAX_KEY = 3, 5, 4
# floor_sk reduces alpha mod q_i by conditional subtracts up to this count of
# them (steps_msk_mod_q), and by one Barrett step beyond it (csrc/tail.cu)
MSK_CSUB_STEPS = 3

KERNEL_NAMES = ("to_bsk_ext", "dyadic", "floor_sk", "relin_dot", "mod_down")
launch_counts = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_U64 = ctypes.c_uint64
_F64 = ctypes.c_double


class Shoup40Struct(ctypes.Structure):
    """Mirror of ``struct Shoup40``: w and floor(w * 2**40 / p) * 2**-40."""

    _fields_ = [("w", _F64), ("ws", _F64)]


class TailParamsStruct(ctypes.Structure):
    """Mirror of ``struct TailParams`` in csrc/tail.cu (same order)."""

    _fields_ = [
        ("k", ctypes.c_int32), ("nbsk", ctypes.c_int32),
        ("k_key", ctypes.c_int32), ("steps_msk_mod_q", ctypes.c_int32),
        ("mt", _U64),
        ("q", _U64 * MAX_K), ("q_mu", _U64 * MAX_K),
        ("bsk", _U64 * MAX_BSK), ("bsk_mu", _U64 * MAX_BSK),
        ("key", _U64 * MAX_KEY), ("key_mu", _U64 * MAX_KEY),
        ("mt_qhinv", _U64 * MAX_K), ("mt_qhinv_s", _U64 * MAX_K),
        ("qhat_bsk", (_U64 * MAX_K) * MAX_BSK),
        ("qhat_bsk_s", (_U64 * MAX_K) * MAX_BSK),
        ("qhat_mt", _U64 * MAX_K),
        ("neg_inv_q_mt", _U64),
        ("q_mod_bsk", _U64 * MAX_BSK), ("q_mod_bsk_s", _U64 * MAX_BSK),
        ("inv_mt_bsk", _U64 * MAX_BSK), ("inv_mt_bsk_s", _U64 * MAX_BSK),
        ("q_d", _F64 * MAX_K), ("bsk_d", _F64 * MAX_BSK),
        ("msk_half_p1", _F64),
        ("fs_y2", (Shoup40Struct * (MAX_K + 1)) * (MAX_BSK - 1)),
        ("fs_alpha", Shoup40Struct * (MAX_BSK + MAX_K)),
        ("fs_out", (Shoup40Struct * (MAX_BSK - 1)) * MAX_K),
        ("fs_corr", (Shoup40Struct * 2) * MAX_K),
        ("P", _U64), ("P_half", _U64),
        ("half_mod_q", _U64 * MAX_K),
        ("inv_P_q", _U64 * MAX_K), ("inv_P_q_s", _U64 * MAX_K),
    ]


def _shoup(w: int, p: int) -> int:
    return int(shoup_precompute(np.uint64(w), np.uint64(p)))


def _shoup40(w: int, p: int) -> int:
    return int(shoup40_precompute(np.uint64(w), np.uint64(p)))


def _mu(p: int) -> int:
    return int(barrett_mu(np.uint64(p)))


class TailConstants:
    """The per-limb constants of the five segments for one parameter set,
    derived from the host model's ``BfvContext``: int64 tensors on `device`
    for the plain versions, and the parameter struct for the kernels.  The
    caller names the device; there is no default."""

    def __init__(self, ctx: BfvContext, device):
        self.device = torch.device(device)
        k, k_key, n = ctx.k, ctx.k_key, ctx.n
        nB, nbsk = len(ctx.B), len(ctx.Bsk)
        self.k, self.k_key, self.n = k, k_key, n
        self.nB, self.nbsk, self.nb = nB, nbsk, k + nbsk
        self.has_keyswitch = ctx.params.special_modulus is not None
        q, bsk, msk, mt = ctx.q_mods, ctx.Bsk, ctx.m_sk, ctx.m_tilde
        if mt & (mt - 1):
            raise ValueError("m_tilde must be a power of two")
        self.mt, self.msk = mt, msk

        # host integers (one source for the tensors and the struct)
        h = {
            "mt_qhinv": [ctx.mtilde_mod_q[i] * ctx.q_hat_inv[i] % q[i]
                         for i in range(k)],
            "qhat_bsk": [[ctx.q_hat[i] % x for i in range(k)] for x in bsk],
            "qhat_mt": [ctx.q_hat[i] % mt for i in range(k)],
            "q_mod_bsk": [ctx.q_mod_x[x] for x in bsk],
            "inv_mt_bsk": [ctx.inv_mtilde_mod_x[x] for x in bsk],
            "inv_q_bsk": [ctx.inv_q_mod_x[x] for x in bsk],
            "bhat_inv": list(ctx.b_hat_inv),
            "bhat_msk": [h_ % msk for h_ in ctx.b_hat],
            "bhat_q": [[h_ % p for h_ in ctx.b_hat] for p in q],
            "prodB_q": list(ctx.prod_B_mod_q),
        }
        self.neg_inv_q_mt = int(ctx.neg_inv_q_mod_mtilde)
        self.inv_prodB_msk = int(ctx.inv_prod_B_mod_msk)
        # floor_sk's kernel folds consecutive constant factors (csrc/tail.cu
        # floor_sk_at): y2_j from x_j and the y_i in one sum, alpha from the
        # y2_j, x_msk and the y_i in one sum, each factor reduced mod its
        # prime; its output sums take bhat_q and -/+ prodB_q as they are
        B, ipb, iq = ctx.B, self.inv_prodB_msk, ctx.inv_q_mod_x
        c_y2 = [iq[b] * ctx.b_hat_inv[j] % b for j, b in enumerate(B)]
        h["fs_y2"] = [[-ctx.q_hat[i] * c_y2[j] % b for i in range(k)]
                      + [c_y2[j]] for j, b in enumerate(B)]
        h["fs_alpha"] = ([ctx.b_hat[j] * ipb % msk for j in range(nB)]
                         + [-iq[msk] * ipb % msk]
                         + [ctx.q_hat[i] * iq[msk] * ipb % msk
                            for i in range(k)])
        # alpha mod q_i by this many conditional subtracts (the reference's
        # steps_msk_mod_q)
        self.steps_msk_mod_q = max((msk - 1) // p for p in q)
        if self.has_keyswitch:
            self.P, self.P_half = int(ctx.P), int(ctx.P_half)
            h["half_mod_q"] = [ctx.P_half % p for p in q]
            h["inv_P_q"] = list(ctx.inv_P_mod_q)
        self._host = h
        # scalar multipliers the plain versions use as Python ints
        self.qhat_mt, self.bhat_msk = h["qhat_mt"], h["bhat_msk"]
        self._mods = {"q": list(q), "bsk": list(bsk),
                      "key": list(ctx.key_mods)}

        def col(v):
            return self._tensor(np.array(v, dtype=np.uint64).reshape(-1, 1))

        self.q, self.bsk, self.key = col(q), col(bsk), col(ctx.key_mods)
        self.b_mods = col(ctx.B)
        self.all_mods = col(list(q) + list(bsk))
        self.mt_qhinv = col(h["mt_qhinv"])
        self.qhat_bsk = self._tensor(np.array(h["qhat_bsk"], dtype=np.uint64))
        self.q_mod_bsk = col(h["q_mod_bsk"])
        self.inv_mt_bsk = col(h["inv_mt_bsk"])
        self.inv_q_bsk = col(h["inv_q_bsk"])
        self.bhat_inv = col(h["bhat_inv"])
        self.bhat_q = self._tensor(np.array(h["bhat_q"], dtype=np.uint64))
        self.prodB_q = col(h["prodB_q"])
        if self.has_keyswitch:
            self.half_mod_q = col(h["half_mod_q"])
            self.inv_P_q = col(h["inv_P_q"])
        self._struct = None

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)
                                ).to(self.device)

    # ------------------------------------------------------------------
    @property
    def struct(self) -> TailParamsStruct:
        """The kernels' parameter struct; refuses a preset that does not fit
        the fixed limb capacities."""
        if self._struct is not None:
            return self._struct
        k, nbsk, k_key = self.k, self.nbsk, self.k_key
        if k > MAX_K or nbsk > MAX_BSK or k_key > MAX_KEY:
            raise ValueError(
                f"parameter set does not fit the tail kernels: k={k} (max "
                f"{MAX_K}), |Bsk|={nbsk} (max {MAX_BSK}), k_key={k_key} "
                f"(max {MAX_KEY})")
        h, m = self._host, self._mods
        s = TailParamsStruct()
        s.k, s.nbsk, s.k_key, s.mt = k, nbsk, k_key, self.mt
        for name, field in (("q", "q"), ("bsk", "bsk"), ("key", "key")):
            for i, p in enumerate(m[name]):
                getattr(s, field)[i] = p
                getattr(s, field + "_mu")[i] = _mu(p)

        def vec(field, values, mods, shoup=True):
            for i, (w, p) in enumerate(zip(values, mods)):
                getattr(s, field)[i] = w
                if shoup:
                    getattr(s, field + "_s")[i] = _shoup(w, p)

        q, bsk, msk = m["q"], m["bsk"], self.msk
        vec("mt_qhinv", h["mt_qhinv"], q)
        for j, x in enumerate(bsk):
            for i in range(k):
                s.qhat_bsk[j][i] = h["qhat_bsk"][j][i]
                s.qhat_bsk_s[j][i] = _shoup(h["qhat_bsk"][j][i], x)
        vec("qhat_mt", h["qhat_mt"], q, shoup=False)
        s.neg_inv_q_mt = self.neg_inv_q_mt
        vec("q_mod_bsk", h["q_mod_bsk"], bsk)
        vec("inv_mt_bsk", h["inv_mt_bsk"], bsk)

        def shoup40(field, w, p):         # w and its word, exact as doubles
            field.w = float(w)
            field.ws = float(_shoup40(w, p)) * 2.0 ** -40

        s.steps_msk_mod_q = self.steps_msk_mod_q
        for i, p in enumerate(q):
            s.q_d[i] = float(p)
            for j in range(self.nB):
                shoup40(s.fs_out[i][j], h["bhat_q"][i][j], p)
            shoup40(s.fs_corr[i][0], -h["prodB_q"][i] % p, p)
            shoup40(s.fs_corr[i][1], h["prodB_q"][i], p)
        for j, x in enumerate(bsk):
            s.bsk_d[j] = float(x)
        s.msk_half_p1 = float(msk // 2 + 1)
        for j in range(self.nB):
            for i in range(k + 1):
                shoup40(s.fs_y2[j][i], h["fs_y2"][j][i], bsk[j])
        for t, w in enumerate(h["fs_alpha"]):
            shoup40(s.fs_alpha[t], w, msk)
        if self.has_keyswitch:
            s.P, s.P_half = self.P, self.P_half
            vec("half_mod_q", h["half_mod_q"], q, shoup=False)
            vec("inv_P_q", h["inv_P_q"], q)
        self._struct = s
        return s


# ======================================================================
# plain PyTorch versions
# ======================================================================
def _fastbconv(y, w, mods):
    """sum_i y[..., i, :] * w[t, i] mod mods[t]: (..., ns, n) -> (..., nt, n).

    Accumulated per source limb, so no (..., nt, ns, n) tensor is formed."""
    acc = None
    for i in range(w.shape[1]):
        term = mulmod(y[..., i:i + 1, :], w[:, i:i + 1], mods)
        acc = term if acc is None else acc + term
    return acc % mods


def to_bsk_ext_plain(a: torch.Tensor, c: TailConstants) -> torch.Tensor:
    """(..., k, n) -> (..., nb, n): [a, lift of a into Bsk] (BEHZ FastBconv
    plus the m_tilde Montgomery correction, centred)."""
    mt, mask = c.mt, c.mt - 1
    y = mulmod(a, c.mt_qhinv, c.q)
    c_bsk = _fastbconv(y, c.qhat_bsk, c.bsk)
    # m_tilde row: power-of-two modulus, arithmetic on the low bits
    acc_mt = (y[..., 0, :] & mask) * c.qhat_mt[0]
    for i in range(1, c.k):
        acc_mt = acc_mt + (y[..., i, :] & mask) * c.qhat_mt[i]
    r = (((acc_mt & mask) * c.neg_inv_q_mt) & mask)[..., None, :]
    rm = torch.where(r > mt // 2, c.bsk - (mt - r), r)
    num = addmod(c_bsk, mulmod(rm, c.q_mod_bsk, c.bsk), c.bsk)
    return torch.cat([a, mulmod(num, c.inv_mt_bsk, c.bsk)], dim=-2)


def dyadic_plain(fa: torch.Tensor, fb: torch.Tensor,
                 c: TailConstants) -> torch.Tensor:
    """(B, 2, nb, n) x (B, 2, nb, n) -> (B, 3, nb, n), Karatsuba."""
    p = c.all_mods
    fa0, fa1, fb0, fb1 = fa[:, 0], fa[:, 1], fb[:, 0], fb[:, 1]
    t0 = mulmod(fa0, fb0, p)
    t2 = mulmod(fa1, fb1, p)
    cross = mulmod(addmod(fa0, fa1, p), addmod(fb0, fb1, p), p)
    t1 = submod(submod(cross, t0, p), t2, p)
    return torch.stack([t0, t1, t2], dim=1)


def fastbconv_sk(fl: torch.Tensor, c: TailConstants) -> torch.Tensor:
    """Shenoy-Kumaresan exact conversion Bsk -> q: (..., nbsk, n) ->
    (..., k, n), with the centred alpha correction through m_sk."""
    nB, msk = c.nB, c.msk
    y = mulmod(fl[..., :nB, :], c.bhat_inv, c.b_mods)
    acc = mulmod(y[..., 0, :], c.bhat_msk[0], msk)
    for j in range(1, nB):
        acc = acc + mulmod(y[..., j, :], c.bhat_msk[j], msk)
    alpha = mulmod(submod(acc % msk, fl[..., nB, :], msk),
                   c.inv_prodB_msk, msk)
    accq = _fastbconv(y, c.bhat_q, c.q)
    a_b = alpha[..., None, :]
    # alpha >= m_sk/2 + 1 stands for the negative alpha - m_sk
    am = torch.where(a_b >= msk // 2 + 1,
                     negmod((msk - a_b) % c.q, c.q), a_b % c.q)
    return submod(accq, mulmod(am, c.prodB_q, c.q), c.q)


def floor_sk_plain(tq: torch.Tensor, c: TailConstants) -> torch.Tensor:
    """(..., nb, n) -> (..., k, n).  tq is the t-scaled tensor in coefficient
    form whose q limbs already carry the q_hat_inv factor."""
    k = c.k
    conv = _fastbconv(tq[..., :k, :], c.qhat_bsk, c.bsk)
    num = submod(tq[..., k:, :], conv, c.bsk)
    return fastbconv_sk(mulmod(num, c.inv_q_bsk, c.bsk), c)


def relin_dot_plain(d_ntt: torch.Tensor, rk: torch.Tensor,
                    c: TailConstants) -> torch.Tensor:
    """(B, k, k_key, n) x (k, 2, k_key, n) -> (B, 2, k_key, n)."""
    comps = []
    for comp in range(2):
        acc = mulmod(d_ntt[:, 0], rk[0, comp], c.key)
        for j in range(1, c.k):
            acc = acc + mulmod(d_ntt[:, j], rk[j, comp], c.key)
        comps.append(acc % c.key)
    return torch.stack(comps, dim=1)


def mod_down_plain(acc: torch.Tensor, ct01: torch.Tensor,
                   c: TailConstants) -> torch.Tensor:
    """(B, 2, k_key, n) + (B, 2, k, n) -> (B, 2, k, n): rounded division by
    the special prime P, added to ct01."""
    k, q = c.k, c.q
    xP_half = addmod(acc[..., c.k_key - 1, :], c.P_half, c.P)
    corr = submod(xP_half[..., None, :] % q, c.half_mod_q, q)
    ti = submod(acc[..., :k, :], corr, q)
    return addmod(ct01, mulmod(ti, c.inv_P_q, q), q)


# ======================================================================
# kernel wrappers
# ======================================================================
def _check(x: torch.Tensor, name: str, shape, contiguous: bool = True):
    if not x.is_cuda:
        raise ValueError(f"{name}: no kernel for a tensor on device "
                         f"{x.device} (CUDA launches the kernel, CPU takes "
                         "the plain version)")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected torch.int64, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


_checked_abi = False


def _library(c: TailConstants):
    """The loaded library, with the struct layout verified once."""
    global _checked_abi
    lib = build.load_library()
    if not _checked_abi:
        if lib.fhe_tail_params_size() != ctypes.sizeof(TailParamsStruct):
            raise RuntimeError("TailParams layout differs between tail.cu "
                               "and tail.py")
        lim = (ctypes.c_int * 4)()
        lib.fhe_tail_limits(lim)
        if tuple(lim) != (MAX_K, MAX_BSK, MAX_KEY, MSK_CSUB_STEPS):
            raise RuntimeError("limb capacities differ between tail.cu and "
                               "tail.py")
        _checked_abi = True
    return lib


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    launch_counts[name] += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def to_bsk_ext(a: torch.Tensor, c: TailConstants) -> torch.Tensor:
    """Kernel for PairTailPallas.to_bsk_ext.  Bound by bytes: reads
    rows*k*n words, writes rows*nb*n."""
    if a.device.type == "cpu":
        return to_bsk_ext_plain(a, c)
    lead = tuple(a.shape[:-2])
    _check(a, "to_bsk_ext", lead + (c.k, c.n))
    prm, lib = c.struct, _library(c)
    out = torch.empty(lead + (c.nb, c.n), dtype=torch.int64, device=a.device)
    _launch("to_bsk_ext", lib.fhe_tail_to_bsk_ext, a.data_ptr(),
            out.data_ptr(), math.prod(lead), c.n, ctypes.addressof(prm),
            _stream(a))
    return out


def dyadic(fa: torch.Tensor, fb: torch.Tensor,
           c: TailConstants) -> torch.Tensor:
    """Kernel for PairTailPallas.dyadic.  Bound by bytes: reads 2 * B*2*nb*n
    words, writes B*3*nb*n."""
    if fa.device.type == "cpu" and fb.device.type == "cpu":
        return dyadic_plain(fa, fb, c)
    if fa.dim() != 4:
        raise ValueError("dyadic: expected (B, 2, nb, n) operands")
    B = fa.shape[0]
    _check(fa, "dyadic", (B, 2, c.nb, c.n))
    _check(fb, "dyadic", (B, 2, c.nb, c.n))
    prm, lib = c.struct, _library(c)
    out = torch.empty((B, 3, c.nb, c.n), dtype=torch.int64, device=fa.device)
    _launch("dyadic", lib.fhe_tail_dyadic, fa.data_ptr(), fb.data_ptr(),
            out.data_ptr(), B, c.n, ctypes.addressof(prm), _stream(fa))
    return out


def floor_sk(tq: torch.Tensor, c: TailConstants) -> torch.Tensor:
    """Kernel for PairTailPallas.floor_sk.  Reads rows*nb*n words, writes
    rows*k*n; two positions a thread in 16-byte words, so n must be even and
    the input 16-byte aligned (the output from ``torch.empty`` is)."""
    if tq.device.type == "cpu":
        return floor_sk_plain(tq, c)
    lead = tuple(tq.shape[:-2])
    _check(tq, "floor_sk", lead + (c.nb, c.n))
    if c.n % 2 or tq.data_ptr() % 16:
        raise ValueError("floor_sk: n must be even and the input 16-byte "
                         "aligned")
    prm, lib = c.struct, _library(c)
    out = torch.empty(lead + (c.k, c.n), dtype=torch.int64, device=tq.device)
    _launch("floor_sk", lib.fhe_tail_floor_sk, tq.data_ptr(), out.data_ptr(),
            math.prod(lead), c.n, ctypes.addressof(prm), _stream(tq))
    return out


def relin_dot(d_ntt: torch.Tensor, rk: torch.Tensor,
              c: TailConstants) -> torch.Tensor:
    """Kernel for PairTailPallas.relin_dot.  Bound by bytes: reads
    B*k*k_key*n digit words and the key once, writes B*2*k_key*n."""
    if d_ntt.device.type == "cpu" and rk.device.type == "cpu":
        return relin_dot_plain(d_ntt, rk, c)
    if d_ntt.dim() != 4:
        raise ValueError("relin_dot: expected (B, k, k_key, n) digits")
    B = d_ntt.shape[0]
    _check(d_ntt, "relin_dot", (B, c.k, c.k_key, c.n))
    _check(rk, "relin_dot", (c.k, 2, c.k_key, c.n))
    prm, lib = c.struct, _library(c)
    out = torch.empty((B, 2, c.k_key, c.n), dtype=torch.int64,
                      device=d_ntt.device)
    _launch("relin_dot", lib.fhe_tail_relin_dot, d_ntt.data_ptr(),
            rk.data_ptr(), out.data_ptr(), B, c.n, ctypes.addressof(prm),
            _stream(d_ntt))
    return out


def mod_down(acc: torch.Tensor, ct01: torch.Tensor,
             c: TailConstants) -> torch.Tensor:
    """Kernel for PairTailPallas.mod_down.  Bound by bytes: reads
    B*2*k_key*n + B*2*k*n words, writes B*2*k*n.  ct01 may be the view
    ``ct3[:, :2]`` of a size-3 batch: only its batch stride is free."""
    if not c.has_keyswitch:
        raise ValueError("mod_down: parameter set has no special prime")
    if acc.device.type == "cpu" and ct01.device.type == "cpu":
        return mod_down_plain(acc, ct01, c)
    if acc.dim() != 4:
        raise ValueError("mod_down: expected (B, 2, k_key, n)")
    B, k, n = acc.shape[0], c.k, c.n
    _check(acc, "mod_down", (B, 2, c.k_key, n))
    _check(ct01, "mod_down", (B, 2, k, n), contiguous=False)
    if tuple(ct01.stride()[1:]) != (k * n, n, 1):
        raise ValueError("mod_down: ct01 must be contiguous within a batch "
                         "row")
    prm, lib = c.struct, _library(c)
    out = torch.empty((B, 2, k, n), dtype=torch.int64, device=acc.device)
    _launch("mod_down", lib.fhe_tail_mod_down, acc.data_ptr(),
            ct01.data_ptr(), out.data_ptr(), B, n, ct01.stride(0),
            ctypes.addressof(prm), _stream(acc))
    return out

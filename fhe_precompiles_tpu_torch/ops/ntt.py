"""Negacyclic NTT over stacks of RNS limbs: two CUDA kernels, their wrappers
and their plain PyTorch versions.

Same transform as ``bfv/ntt.py`` (Cooley-Tukey forward, Gentleman-Sande
inverse, twiddles in SEAL's bit-reversed layout) over tensors shaped
``(..., L, n)`` where row ``l`` of the limb axis is reduced mod ``moduli[l]``.
Forward input and every output are canonical residues.

  =======  ==============================================  ================
  wrapper  replaces (fhe_precompiles_tpu/ops/              plain version
           pallas_pair_ntt.py)
  =======  ==============================================  ================
  ntt      PairPallasNtt.ntt  / _kernel_factory(False)     ntt_plain
  intt     PairPallasNtt.intt / _kernel_factory(True)      intt_plain
  =======  ==============================================  ================

``ntt`` / ``intt`` take the plain version only for a tensor that lies on the
CPU.  For a CUDA tensor they launch the kernel of ``csrc/ntt.cu`` on
PyTorch's current stream (no synchronise; the output comes from
``torch.empty``, or is the caller's ``out=``) or raise; nothing falls back.
Each adds one to ``launch_counts[name]`` where it launches.

The plain versions are the plainest exact schedule: radix 2, one pass per
stage, every butterfly fully reduced.  The kernels keep values lazy between
stages (Harvey) and use 40-bit Shoup twiddles, as the JAX kernel does
(``shoup_bits=40``); both are exact arithmetic on canonical inputs, so they
give the same bytes, and so does the JAX reference.
Nothing on the card's path calls the plain versions.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..bfv.modmath import get_ntt_tables
from . import build
from .modmath import addmod, mulmod, shoup40_precompute, submod

KERNEL_NAMES = ("ntt", "intt")
MAX_MODULUS = 1 << 37     # so that the kernels' lazy values stay below 2**39
# the largest n whose row fits one block's shared memory beside the limb's
# tables: csrc/ntt.cu fhe_ntt_max_n(), which the wrapper holds it to
MAX_N = 8192
launch_counts = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@dataclasses.dataclass(frozen=True)
class NttTables:
    """Twiddle tables for a stack of L moduli, int64 tensors on one device.

    The ``*_shoup40`` companions hold floor(w * 2**40 / p) for the word beside
    them, the port's copy of ``ops/pair.py::shoup40`` (only the kernels read
    them; every modulus is below 2**37)."""

    n: int
    p: torch.Tensor                 # (L, 1)
    root: torch.Tensor              # (L, n) forward twiddles, bit-reversed
    inv_root: torch.Tensor          # (L, n)
    n_inv: torch.Tensor             # (L, 1): n^-1 (times the folded factor)
    root_shoup40: torch.Tensor      # (L, n)
    inv_root_shoup40: torch.Tensor  # (L, n)
    n_inv_shoup40: torch.Tensor     # (L, 1)


def _dev(arr, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.uint64).view(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _host_rows(p: int, n: int):
    """(root, root_shoup40, inv_root, inv_root_shoup40, n_inv) of one
    modulus."""
    t = get_ntt_tables(p, n)
    root = np.asarray(t.root_powers, dtype=np.uint64)
    inv_root = np.asarray(t.inv_root_powers, dtype=np.uint64)
    return (root, shoup40_precompute(root, p), inv_root,
            shoup40_precompute(inv_root, p), int(t.n_inv))


def build_tables(moduli: Sequence[int], n: int, device,
                 n_inv_factors: Optional[Sequence[int]] = None) -> NttTables:
    """Tables on `device`, which the caller names (there is no default).
    n_inv_factors: optional per-limb constants folded into the inverse
    transform's n^-1 multiply, so that ``intt`` returns ``factor * x``
    without a separate pass (the engine folds t and t * q_hat_inv there).
    Every modulus must lie below 2**37: the kernels' 40-bit Shoup product
    relies on lazy values below 2**39."""
    moduli = [int(p) for p in moduli]
    big = [p for p in moduli if p >= MAX_MODULUS]
    if big:
        raise ValueError(f"build_tables: moduli must be below 2**37, got "
                         f"{big}")
    rows = [_host_rows(p, n) for p in moduli]
    n_inv = [r[4] for r in rows]
    if n_inv_factors is not None:
        n_inv = [v * int(f) % p for v, f, p in zip(n_inv, n_inv_factors, moduli)]
    col = lambda v: np.array(v, dtype=np.uint64).reshape(-1, 1)  # noqa: E731
    stack = lambda i: _dev(np.stack([r[i] for r in rows]), device)  # noqa: E731
    return NttTables(
        n=n,
        p=_dev(col(moduli), device),
        root=stack(0),
        inv_root=stack(2),
        n_inv=_dev(col(n_inv), device),
        root_shoup40=stack(1),
        inv_root_shoup40=stack(3),
        n_inv_shoup40=_dev(shoup40_precompute(col(n_inv), col(moduli)),
                           device),
    )


# ======================================================================
# plain PyTorch versions
# ======================================================================
def ntt_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
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


def intt_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
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


# ======================================================================
# kernel wrappers
# ======================================================================
def _group_stride(x: torch.Tensor, name: str, L: int, n: int) -> int:
    """The distance in words between successive (L, n) blocks of `x`, which
    the kernel takes as it is.  Each block must be contiguous and the leading
    axes must step evenly (a contiguous tensor, or a view such as
    ``ct[:, comp]`` of a contiguous (B, size, L, n) batch); anything else is
    refused, not copied."""
    if x.dim() == 2 or x.is_contiguous():
        stride = L * n
        inner = x.stride()[-2:]
    else:
        try:
            flat = x.view(-1, L, n)
        except RuntimeError:
            raise ValueError(f"{name}: the leading axes of a strided input "
                             "must collapse into one even step") from None
        stride, inner = flat.stride(0), flat.stride()[1:]
    if x.numel() and n > 1 and tuple(inner) != (n, 1):
        raise ValueError(f"{name}: each (L, n) block must be contiguous, got "
                         f"strides {tuple(x.stride())}")
    if x.data_ptr() % 16 or stride % 2:
        raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    return stride


def _check_input(name: str, x: torch.Tensor, tables_device: torch.device,
                tail: Sequence[int]) -> None:
    """What every NTT kernel wrapper takes: an int64 tensor on a card, its
    last axes `tail`, the tables on the same card."""
    if not x.is_cuda:
        raise ValueError(f"{name}: no kernel for a tensor on device "
                         f"{x.device} (CUDA launches the kernel, CPU takes "
                         "the plain version)")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected torch.int64, got {x.dtype}")
    tail = tuple(tail)
    if x.dim() < len(tail) or tuple(x.shape[-len(tail):]) != tail:
        raise ValueError(f"{name}: expected shape (..., "
                         f"{', '.join(map(str, tail))}), got "
                         f"{tuple(x.shape)}")
    if tables_device != x.device:
        raise ValueError(f"{name}: tables on {tables_device}, data on "
                         f"{x.device}")


def _output(name: str, out: Optional[torch.Tensor], shape,
            device: torch.device) -> torch.Tensor:
    """The buffer a kernel writes whole: a new one from ``torch.empty``, or
    the caller's `out`, which must be a contiguous, 16-byte aligned int64
    tensor of `shape` on `device` that overlaps no input."""
    if out is None:
        return torch.empty(shape, dtype=torch.int64, device=device)
    if (out.dtype != torch.int64 or out.device != device
            or tuple(out.shape) != tuple(shape) or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(f"{name}: out must be a contiguous, 16-byte aligned "
                         f"int64 tensor of shape {tuple(shape)} on {device}")
    return out


def _into(name: str, out: Optional[torch.Tensor],
          result: torch.Tensor) -> torch.Tensor:
    """A plain version's `result`, or its words copied into `out` (checked
    as ``_output`` checks it)."""
    if out is None:
        return result
    return _output(name, out, result.shape, result.device).copy_(result)


def _launch(name: str, x: torch.Tensor, tb: NttTables,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    L, n = tb.p.shape[0], tb.n
    _check_input(name, x, tb.p.device, (L, n))
    stride = _group_stride(x, name, L, n)
    lib = build.load_library()
    if lib.fhe_ntt_max_n() != MAX_N:
        raise RuntimeError(f"{name}: the library takes n up to "
                           f"{lib.fhe_ntt_max_n()}, MAX_N says {MAX_N}")
    if n < 8 or n > MAX_N:
        raise ValueError(f"{name}: the kernel takes 8 <= n <= {MAX_N} (a row "
                         "and the limb's tables must fit one block's shared "
                         f"memory), got n = {n}")
    out = _output(name, out, x.shape, x.device)
    rows = math.prod(x.shape[:-1])
    with torch.cuda.device(x.device):      # the launch goes to x's card
        stream = torch.cuda.current_stream().cuda_stream
        if name == "ntt":
            rc = lib.fhe_ntt_forward(
                x.data_ptr(), out.data_ptr(), rows, L, n, stride,
                tb.p.data_ptr(), tb.root.data_ptr(),
                tb.root_shoup40.data_ptr(), stream)
        else:
            rc = lib.fhe_ntt_inverse(
                x.data_ptr(), out.data_ptr(), rows, L, n, stride,
                tb.p.data_ptr(), tb.inv_root.data_ptr(),
                tb.inv_root_shoup40.data_ptr(), tb.n_inv.data_ptr(),
                tb.n_inv_shoup40.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    if rows:                    # the library launches nothing for 0 rows
        launch_counts[name] += 1
    return out


def ntt(x: torch.Tensor, tb: NttTables, *,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward NTT of (..., L, n): natural order in, bit-reversed out.
    Kernel for PairPallasNtt.ntt.  Bound by bytes: reads and writes
    rows * n words once."""
    if x.device.type == "cpu":
        return _into("ntt", out, ntt_plain(x, tb))
    return _launch("ntt", x, tb, out)


def intt(x: torch.Tensor, tb: NttTables, *,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse NTT of (..., L, n): bit-reversed in, natural order out, times
    tb.n_inv.  Kernel for PairPallasNtt.intt.  Bound by bytes, as ``ntt``."""
    if x.device.type == "cpu":
        return _into("intt", out, intt_plain(x, tb))
    return _launch("intt", x, tb, out)


class ButterflyNtt:
    """``ntt`` / ``intt`` over one stack of moduli with its tables: the
    engine's default transform (``FourStepNtt`` is the other)."""

    def __init__(self, moduli: Sequence[int], n: int, device,
                 n_inv_factors: Optional[Sequence[int]] = None):
        self.tables = build_tables(moduli, n, device, n_inv_factors)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return ntt(x, self.tables)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return intt(x, self.tables)

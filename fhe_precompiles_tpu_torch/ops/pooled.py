"""A pooled block's add and sub groups in one pass: the CUDA kernel
``pooled_addsub_kernel`` (``csrc/pooled.cu``), its wrapper and its plain
version.

``RequestStream``'s pooled calls name each request's operands by their
index into a pool of ciphertexts on the device.  ``pooled_addsub`` takes the
pool, a group's a and b index vectors and the ciphertext primes, and returns
(M, 2, k, n): ``(pool[ia[r]] + pool[ib[r]]) mod q_j``, or the difference, for
each request r.  The kernel reads the two operand rows straight from the
pool and writes each result word once; the plain version gathers both
operands (``index_select``) and runs ``ops/modmath.py`` ``addmod`` /
``submod`` on them, the arithmetic of ``TorchEngine._add`` / ``_sub``, so
the two agree word for word.

The wrapper takes the plain version only for a pool on the CPU.  For a CUDA
pool it launches the kernel on PyTorch's current stream (no synchronise; the
output from ``torch.empty``, or the caller's ``out=``) or raises; nothing
falls back.  It adds one to ``launch_counts["pooled_addsub"]`` where it
launches, and launches nothing for zero requests.  The kernel does not read
outside the pool: an index outside [0, P) stops it with a trap, which loses
the CUDA context as ``index_select``'s device assert does, so a caller
checks its indices on the host first (``RequestStream._stage`` does).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import build
from .modmath import addmod, submod
from .ntt import _into, _output
from .tail import _check

# the moduli the kernel's launch parameters hold (csrc/pooled.cu)
MAX_K = 3

KERNEL_NAMES = ("pooled_addsub",)
launch_counts = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def pooled_addsub_plain(pool: torch.Tensor, ia: torch.Tensor,
                        ib: torch.Tensor, q: Sequence[int],
                        sub: bool) -> torch.Tensor:
    """The operands gathered, then ``addmod`` / ``submod`` over the (k, 1)
    column of the moduli."""
    a, b = pool.index_select(0, ia), pool.index_select(0, ib)
    p = torch.tensor([int(x) for x in q], dtype=torch.int64,
                     device=pool.device).view(-1, 1)
    return submod(a, b, p) if sub else addmod(a, b, p)


_checked_limit = False


def pooled_addsub(pool: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                  q: Sequence[int], sub: bool, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a + b) mod q, or (a - b) mod q, of the pool rows that `ia` and `ib`
    name: pool (P, 2, k, n) int64 of canonical residues, contiguous; ia, ib
    (M,) int64 on the pool's device, each index in [0, P); q the k
    ciphertext primes as integers.  Returns (M, 2, k, n).  Bound by bytes:
    reads 2 M rows of 2 k n words, writes M rows."""
    global _checked_limit
    name = "pooled_addsub"
    if pool.device.type == "cpu":
        return _into(name, out, pooled_addsub_plain(pool, ia, ib, q, sub))
    if pool.dim() != 4 or ia.dim() != 1:
        raise ValueError(f"{name}: expected a (P, 2, k, n) pool and (M,) "
                         "indices")
    P, _, k, n = pool.shape
    M = ia.shape[0]
    _check(pool, name, (P, 2, len(q), n))
    _check(ia, name, (M,))
    _check(ib, name, (M,))
    if ia.device != pool.device or ib.device != pool.device:
        raise ValueError(f"{name}: the indices must lie on the pool's device "
                         f"{pool.device}")
    if k > MAX_K or n % 2 or 2 * k * n >= 1 << 31 or pool.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes k <= {MAX_K} (MAX_K), an "
                         "even n with 2 k n < 2^31 and a 16-byte aligned "
                         f"pool; got k = {k}, n = {n}")
    out = _output(name, out, (M, 2, k, n), pool.device)
    if M == 0:                  # the library launches nothing for 0 rows
        return out
    lib = build.load_library()
    if not _checked_limit:
        if lib.fhe_pooled_max_k() != MAX_K:
            raise RuntimeError(f"{name}: the library takes k up to "
                               f"{lib.fhe_pooled_max_k()}, MAX_K says {MAX_K}")
        _checked_limit = True
    mods = (ctypes.c_uint64 * k)(*[int(x) for x in q])
    with torch.cuda.device(pool.device):   # the launch goes to the pool's card
        rc = lib.fhe_pooled_addsub(
            pool.data_ptr(), ia.data_ptr(), ib.data_ptr(), out.data_ptr(), M,
            P, k, n, mods, int(bool(sub)),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    launch_counts[name] += 1
    return out

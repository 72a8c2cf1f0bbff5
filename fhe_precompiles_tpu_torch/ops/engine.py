"""TorchEngine: batched BFV multiply + relinearize on int64 residue tensors.

Counterpart of ``fhe_precompiles_tpu/ops/engine.py`` (``JaxEngine``) for the
multiply path.  Every method reproduces ``bfv/golden.py`` arrays exactly.

Layouts (the JAX engine's):
  ct batch    int64 (B, size, k, n)      coefficient form
  relin keys  int64 (k, 2, k_key, n)     NTT form
  prepared    int64 (B, 2, nb, n)        NTT form over q u Bsk

The engine runs on the card unless the caller names another device.  Its
constants are tensors on that device, built once in the constructor.  There
is no tracing or compilation step: every call runs eagerly.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import convert
from ..bfv.golden import BfvContext, Ciphertext, RelinKeys
from ..params import Params
from .behz import Behz
from .ntt import build_tables
from .tail import TailConstants


def pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    """Pad the leading (batch) axis to `target` by repeating row 0 on the
    tensor's device.  Pad rows are garbage-in-garbage-out and trimmed by
    callers."""
    b = x.shape[0]
    if b == target:
        return x
    return torch.cat([x, x[:1].expand((target - b,) + tuple(x.shape[1:]))])


class TorchEngine:
    """Batched multiply + relinearize for one parameter set on one device."""

    def __init__(self, params: Params, device="cuda",
                 golden: Optional[BfvContext] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine: device 'cuda' requested but no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        self.params = params
        g = golden if golden is not None else BfvContext(params)
        self.golden = g
        self.n, self.k, self.k_key = g.n, g.k, g.k_key
        self.nb = g.k + len(g.Bsk)
        dev = self.device

        all_mods = g.q_mods + g.Bsk
        tb_all = build_tables(all_mods, g.n, dev)
        # mul_core's inverse transform folds the FastFloor pre-scale t and,
        # for the q limbs, the FastBconv q_hat_inv scalar into n^-1
        qh_t = [params.t * int(g.q_hat_inv[i]) % int(p)
                for i, p in enumerate(g.q_mods)]
        tb_all_t = build_tables(all_mods, g.n, dev,
                                n_inv_factors=qh_t + [params.t] * len(g.Bsk))
        has_ks = params.special_modulus is not None
        tb_key = build_tables(g.key_mods, g.n, dev) if has_ks else None
        # c2 residues are < max(q); this many conditional subtracts reduce
        # them mod every key prime
        steps = max((max(g.q_mods) - 1) // p for p in g.key_mods)
        self.consts = TailConstants(g, dev)
        self.behz = Behz(self.consts, tb_all, tb_all_t, tb_key, steps)

    # ==================================================================
    # batched ops
    # ==================================================================
    def _prepare(self, a: torch.Tensor) -> torch.Tensor:
        """(B, 2, k, n) ct -> (B, 2, nb, n): the operand-independent half of
        the multiply (Bsk lift + forward transforms over all bases)."""
        return self.behz.prepare(a)

    def _mul_core(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Prepared x prepared -> (B, 3, k, n)."""
        return self.behz.mul_core(fa, fb)

    def _multiply(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B, 2, k, n) x (B, 2, k, n) -> (B, 3, k, n) BEHZ tensor + scale."""
        return self.behz.mul_core(self.behz.prepare(a), self.behz.prepare(b))

    def _relinearize(self, ct3: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
        """(B, 3, k, n) + rk (k, 2, k_key, n) -> (B, 2, k, n)."""
        return self.behz.relinearize(ct3, rk)

    def _mul_relin(self, a: torch.Tensor, b: torch.Tensor,
                   rk: torch.Tensor) -> torch.Tensor:
        return self.behz.relinearize(self._multiply(a, b), rk)

    def _mul_relin_prepared(self, fa: torch.Tensor, fb: torch.Tensor,
                            rk: torch.Tensor) -> torch.Tensor:
        return self.behz.relinearize(self.behz.mul_core(fa, fb), rk)

    # ==================================================================
    # single-ciphertext protocol (host glue)
    # ==================================================================
    def _wrap(self, data: torch.Tensor) -> Ciphertext:
        return Ciphertext(self.params, convert.to_numpy(data))

    def _ct(self, ct: Ciphertext) -> torch.Tensor:
        return convert.ciphertexts_from_numpy(ct.data[None], self.device)

    def _rk(self, rk: RelinKeys) -> torch.Tensor:
        return convert.relin_keys_from_numpy(rk.data, self.device)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.size != 2 or b.size != 2:
            raise ValueError("multiply expects size-2 ciphertexts")
        return self._wrap(self._multiply(self._ct(a), self._ct(b))[0])

    def relinearize(self, ct: Ciphertext, rk: RelinKeys) -> Ciphertext:
        if ct.size != 3:
            raise ValueError("relinearize expects a size-3 ciphertext")
        return self._wrap(self._relinearize(self._ct(ct), self._rk(rk))[0])

    def mul_relin(self, a: Ciphertext, b: Ciphertext,
                  rk: RelinKeys) -> Ciphertext:
        if a.size != 2 or b.size != 2:
            raise ValueError("multiply expects size-2 ciphertexts")
        return self._wrap(
            self._mul_relin(self._ct(a), self._ct(b), self._rk(rk))[0])

"""BEHZ multiply + relinearization pipeline on int64 residue tensors.

Counterpart of ``fhe_precompiles_tpu/ops/behz_pair.py`` (``PairBehz.prepare``,
``mul_core``, ``relinearize``) in its ``pair_tail="pallas"`` configuration:
the five pointwise segments go through the wrappers of ``ops/tail.py`` and the
NTTs between them through the engine's transforms (``ops/ntt.py`` or
``ops/four_step.py``; CUDA kernels on the card, plain versions on the CPU):
three forward and two inverse transforms for one multiply + relinearize.

The u32-pair representation of the reference does not exist here: the card
multiplies 64-bit words natively, so residues stay whole int64 words from end
to end.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import tail
from .modmath import csub_reduce

Transform = Callable[[torch.Tensor], torch.Tensor]


class Behz:
    """The three stages of multiply + relinearize for one parameter set.
    ntt_all: forward over q u Bsk; intt_all_t: inverse over q u Bsk with
    t * q_hat_inv (q limbs) and t (Bsk limbs) folded in; ntt_key / intt_key:
    over the key primes (None without a special prime)."""

    def __init__(self, consts: tail.TailConstants, ntt_all: Transform,
                 intt_all_t: Transform, ntt_key: Optional[Transform],
                 intt_key: Optional[Transform], steps_ct_mod_key: int):
        self.c = consts
        self.ntt_all, self.intt_all_t = ntt_all, intt_all_t
        self.ntt_key, self.intt_key = ntt_key, intt_key
        self.steps_ct_mod_key = steps_ct_mod_key

    def prepare(self, a: torch.Tensor) -> torch.Tensor:
        """(B, 2, k, n) ct -> (B, 2, nb, n) NTT-domain extended operand."""
        return self.ntt_all(tail.to_bsk_ext(a, self.c))

    def mul_core(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Prepared x prepared -> (B, 3, k, n) scaled tensor.

        The inverse transform's n^-1 carries t for the Bsk limbs and
        t * q_hat_inv for the q limbs, so its q limbs feed FastBconv as
        they are."""
        tq = self.intt_all_t(tail.dyadic(fa, fb, self.c))
        return tail.floor_sk(tq, self.c)

    def relinearize(self, ct3: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
        """(B, 3, k, n) + rk (k, 2, k_key, n) NTT form -> (B, 2, k, n)."""
        if self.ntt_key is None:
            raise ValueError("relinearize: parameter set has no special "
                             "prime, so no key switching")
        # lift every decomposition digit mod every key prime: (B, k, k_key, n)
        d = csub_reduce(ct3[:, 2, :, None, :], self.c.key,
                        self.steps_ct_mod_key)
        acc_ntt = tail.relin_dot(self.ntt_key(d), rk, self.c)
        return tail.mod_down(self.intt_key(acc_ntt), ct3[:, :2], self.c)

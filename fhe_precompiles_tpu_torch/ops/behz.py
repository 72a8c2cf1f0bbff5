"""BEHZ multiply + relinearization pipeline on int64 residue tensors.

Counterpart of ``fhe_precompiles_tpu/ops/behz_pair.py`` (``PairBehz.prepare``,
``mul_core``, ``relinearize``) in its ``pair_tail="pallas"`` configuration:
the five pointwise segments go through the wrappers of ``ops/tail.py`` and the
NTTs between them through those of ``ops/ntt.py`` (CUDA kernels on the card,
plain versions on the CPU): three forward and two inverse transforms for one
multiply + relinearize.

The u32-pair representation of the reference does not exist here: the card
multiplies 64-bit words natively, so residues stay whole int64 words from end
to end.
"""
from __future__ import annotations

import torch

from . import tail
from .modmath import csub_reduce
from .ntt import NttTables, intt, ntt


class Behz:
    """The three stages of multiply + relinearize for one parameter set."""

    def __init__(self, consts: tail.TailConstants, tb_all: NttTables,
                 tb_all_t: NttTables, tb_key: NttTables | None,
                 steps_ct_mod_key: int):
        self.c = consts
        self.tb_all, self.tb_all_t, self.tb_key = tb_all, tb_all_t, tb_key
        self.steps_ct_mod_key = steps_ct_mod_key

    def prepare(self, a: torch.Tensor) -> torch.Tensor:
        """(B, 2, k, n) ct -> (B, 2, nb, n) NTT-domain extended operand."""
        return ntt(tail.to_bsk_ext(a, self.c), self.tb_all)

    def mul_core(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Prepared x prepared -> (B, 3, k, n) scaled tensor.

        The inverse transform's n^-1 carries t for the Bsk limbs and
        t * q_hat_inv for the q limbs, so its q limbs feed FastBconv as
        they are."""
        tq = intt(tail.dyadic(fa, fb, self.c), self.tb_all_t)
        return tail.floor_sk(tq, self.c)

    def relinearize(self, ct3: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
        """(B, 3, k, n) + rk (k, 2, k_key, n) NTT form -> (B, 2, k, n)."""
        if self.tb_key is None:
            raise ValueError("relinearize: parameter set has no special "
                             "prime, so no key switching")
        # lift every decomposition digit mod every key prime: (B, k, k_key, n)
        d = csub_reduce(ct3[:, 2, :, None, :], self.c.key,
                        self.steps_ct_mod_key)
        acc_ntt = tail.relin_dot(ntt(d, self.tb_key), rk, self.c)
        return tail.mod_down(intt(acc_ntt, self.tb_key), ct3[:, :2], self.c)

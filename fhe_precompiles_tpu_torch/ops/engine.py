"""TorchEngine: batched BFV operations on int64 residue tensors.

Counterpart of ``fhe_precompiles_tpu/ops/engine.py`` (``JaxEngine``): encrypt,
decrypt, the elementwise operations, multiply and relinearize.  Every method
reproduces ``bfv/golden.py`` arrays exactly.

Layouts (the JAX engine's):
  ct batch    int64 (B, size, k, n)      coefficient form
  plaintexts  int64 (B, n)               coefficients mod t
  pk          int64 (2, k_key, n)        NTT form
  relin keys  int64 (k, 2, k_key, n)     NTT form
  prepared    int64 (B, 2, nb, n)        NTT form over q u Bsk

Every NTT goes through the transforms of the NTT backend the caller names,
and the five BEHZ segments through the wrappers of ``ops/tail.py``: CUDA
kernels on the card, plain versions on the CPU.  ``ntt_backend`` is
"butterfly" (the default: ``ops/ntt.py``, the counterpart of the JAX
engine's "pair" backend) or "four_step" (``ops/four_step.py``, digit matrix
products on the tensor cores: the counterpart of its "pallas" backend).  As
in ``JaxEngine`` the engine holds each transform as a callable:
``_ntt_q`` / ``_intt_q`` (encrypt, decrypt, ``_mul_plain``), ``_ntt_all``
and ``_intt_all_t`` (the multiply), ``_ntt_key`` / ``_intt_key`` (the
relinearization).  What lies between them here (additions, the Delta
scaling, the products with the secret key, the exact rounding of decrypt) is
plain torch arithmetic, as the reference leaves it to its compiler.

The engine runs on the card unless the caller names another device.  Its
constants are tensors on that device, built once in the constructor.  There
is no tracing or compilation step: every call runs eagerly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import convert
from ..bfv.golden import (BfvContext, Ciphertext, PublicKey, RelinKeys,
                          SecretKey)
from ..params import Params
from ..sampling import (Blake2Xof, DOMAIN_ERROR, DOMAIN_TERNARY, sample_cbd,
                        sample_ternary)
from .behz import Behz
from .modmath import addmod, csub_reduce, mulmod, negmod, submod
from . import four_step, ntt, tail
from .four_step import FourStepNtt
from .ntt import ButterflyNtt
from .tail import TailConstants
from .wide import ExactScaleRound


# the transforms of each ``ntt_backend``: classes with ``ntt`` / ``intt``
# taking (moduli, n, device, n_inv_factors=...)
NTT_BACKENDS = {"butterfly": ButterflyNtt, "four_step": FourStepNtt}


def check_card_limits(g: BfvContext, ntt_backend: str) -> None:
    """Refuses, with one ValueError that names the limit, a parameter set
    that the kernels an engine on the card launches cannot take, where the
    JAX package computes it: the tail kernels' limb capacities (``MAX_K``,
    ``MAX_BSK``, ``MAX_KEY`` of ops/tail.py), the butterfly NTT's largest n
    (``MAX_N`` of ops/ntt.py), the four-step NTT's sides R = n / C with
    C = 64 (``kernel_fit`` of ops/four_step.py).  There is no fallback to
    the CPU: the caller may name device="cpu"."""
    nbsk = len(g.Bsk)
    if g.k > tail.MAX_K or nbsk > tail.MAX_BSK or g.k_key > tail.MAX_KEY:
        raise ValueError(
            f"TorchEngine on the card: the tail kernels take k <= "
            f"{tail.MAX_K} (MAX_K), |Bsk| <= {tail.MAX_BSK} (MAX_BSK) and "
            f"k_key <= {tail.MAX_KEY} (MAX_KEY); this parameter set has "
            f"k = {g.k}, |Bsk| = {nbsk}, k_key = {g.k_key}")
    if ntt_backend == "butterfly" and not 8 <= g.n <= ntt.MAX_N:
        raise ValueError(f"TorchEngine on the card: the butterfly NTT kernel "
                         f"takes 8 <= n <= {ntt.MAX_N} (MAX_N), got "
                         f"n = {g.n}")
    if ntt_backend == "four_step":
        C = four_step.DEFAULT_C
        R = g.n // C
        if R * C != g.n or four_step.kernel_fit(R, C)[0] == 0:
            raise ValueError(
                f"TorchEngine on the card: the four-step NTT kernel takes "
                f"n = R * {C} with R in {four_step.KERNEL_SIDES} "
                f"(kernel_fit), got n = {g.n}")


def pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    """Pad the leading (batch) axis to `target` by repeating row 0 on the
    tensor's device.  Pad rows are garbage-in-garbage-out and trimmed by
    callers."""
    b = x.shape[0]
    if b == target:
        return x
    return torch.cat([x, x[:1].expand((target - b,) + tuple(x.shape[1:]))])


class TorchEngine:
    """All batched BFV operations for one parameter set on one device."""

    def __init__(self, params: Params, device="cuda",
                 golden: Optional[BfvContext] = None,
                 ntt_backend: str = "butterfly"):
        if ntt_backend not in NTT_BACKENDS:
            raise ValueError(f"unknown ntt_backend {ntt_backend!r}")
        self.ntt_backend = ntt_backend
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine: device 'cuda' requested but no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        self.params = params
        g = golden if golden is not None else BfvContext(params)
        if self.device.type == "cuda":
            check_card_limits(g, ntt_backend)
        self.golden = g
        self.n, self.k, self.k_key = g.n, g.k, g.k_key
        self.nb = g.k + len(g.Bsk)
        dev = self.device

        transform = NTT_BACKENDS[ntt_backend]
        all_mods = g.q_mods + g.Bsk
        # mul_core's inverse transform folds the FastFloor pre-scale t and,
        # for the q limbs, the FastBconv q_hat_inv scalar into n^-1
        qh_t = [params.t * int(g.q_hat_inv[i]) % int(p)
                for i, p in enumerate(g.q_mods)]
        has_ks = params.special_modulus is not None
        # one transform object per stack of moduli: q (encrypt, decrypt,
        # mul_plain), q u Bsk forward and inverse with the fold, key primes
        self.ntts = {
            "q": transform(g.q_mods, g.n, dev),
            "all": transform(all_mods, g.n, dev),
            "all_t": transform(all_mods, g.n, dev,
                               n_inv_factors=qh_t + [params.t] * len(g.Bsk)),
            "key": transform(g.key_mods, g.n, dev) if has_ks else None,
        }
        self._ntt_q, self._intt_q = self.ntts["q"].ntt, self.ntts["q"].intt
        self._ntt_all = self.ntts["all"].ntt
        self._intt_all_t = self.ntts["all_t"].intt
        self._ntt_key, self._intt_key = (
            (self.ntts["key"].ntt, self.ntts["key"].intt) if has_ks
            else (None, None))
        # c2 residues are < max(q); this many conditional subtracts reduce
        # them mod every key prime
        steps = max((max(g.q_mods) - 1) // p for p in g.key_mods)
        self.consts = TailConstants(g, dev)
        self.behz = Behz(self.consts, self._ntt_all, self._intt_all_t,
                         self._ntt_key, self._intt_key, steps)

        self.q_mods = self.consts.q                       # (k, 1)
        if params.t * params.t >= 1 << 63:
            raise ValueError("plain modulus too large for the int64 carrier")
        self.q_mod_t = int(g.q_mod_t)

        def col(values):
            return convert.from_numpy(
                np.array([int(v) for v in values], dtype=np.uint64
                         ).reshape(-1, 1), dev)
        self.delta_mod_q = col(g.delta_mod_q)
        self.q_hat_inv = col(g.q_hat_inv)
        # plaintext coefficients are < t: this many conditional subtracts
        # reduce them mod every ciphertext prime
        self.steps_t_mod_q = max((params.t - 1) // p for p in g.q_mods)
        self._exact_round = ExactScaleRound(g.q_mods, params.t)

    # ==================================================================
    # elementwise ops (any leading axes before (k, n))
    # ==================================================================
    def _add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return addmod(a, b, self.q_mods)

    def _sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return submod(a, b, self.q_mods)

    def _neg(self, a: torch.Tensor) -> torch.Tensor:
        return negmod(a, self.q_mods)

    def _scaled_plain(self, m: torch.Tensor) -> torch.Tensor:
        """round(q*m/t) per limb: (..., n) plain -> (..., k, n).

        Same exact identity as golden._scale_plain: (delta mod q_j)*m + fix.
        """
        t = self.params.t
        fix = (self.q_mod_t * m + t // 2) // t
        term = mulmod(m[..., None, :], self.delta_mod_q, self.q_mods)
        return addmod(term, fix[..., None, :], self.q_mods)

    def _with_first(self, ct: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
        """`ct` (..., size, k, n) with its first component replaced."""
        return torch.cat([c0[..., None, :, :], ct[..., 1:, :, :]], dim=-3)

    def _add_plain(self, ct: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        return self._with_first(
            ct, addmod(ct[..., 0, :, :], self._scaled_plain(m), self.q_mods))

    def _sub_plain(self, ct: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        return self._with_first(
            ct, submod(ct[..., 0, :, :], self._scaled_plain(m), self.q_mods))

    def _plain_sub(self, m: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
        out = negmod(ct, self.q_mods)
        return self._with_first(
            out, addmod(out[..., 0, :, :], self._scaled_plain(m), self.q_mods))

    def _mul_plain(self, ct: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """(..., size, k, n) x (..., n) plain: every component times the
        plain polynomial (lifted mod each q_j, transformed once)."""
        # the lift broadcasts m over the limb axis; the transform wants rows
        # in memory, so the copy is made here, in the open
        m_rns = csub_reduce(m[..., None, :], self.q_mods,
                            self.steps_t_mod_q).contiguous()
        m_ntt = self._ntt_q(m_rns)
        c_ntt = self._ntt_q(ct)
        out = mulmod(c_ntt, m_ntt[..., None, :, :], self.q_mods)
        return self._intt_q(out)

    # ==================================================================
    # BEHZ multiply and relinearization
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
    # batched decryption (exact CRT scale-and-round, any ct size)
    # ==================================================================
    def _decrypt_fn(self, size: int):
        """Decrypt for a fixed ciphertext component count >= 2.

        dot = sum_comp c_comp * s^comp per limb (golden._dot_with_secret; a
        wire ciphertext may carry 3 or more components), then the exact
        m = round(t*x/q) mod t of ``ops/wide.py``.  Each component is
        transformed as the strided view ``ct[:, comp]``: the kernel takes the
        batch stride."""
        if size < 2:
            raise ValueError("decrypt expects a ciphertext with >= 2 "
                             f"components, got {size}")

        def f(ct: torch.Tensor, s_ntt: torch.Tensor) -> torch.Tensor:
            """(B, size, k, n) ct + s_ntt (k, n) -> (B, n) plaintext mod t."""
            acc = None
            cur = s_ntt
            for comp in range(1, size):
                term = mulmod(self._ntt_q(ct[:, comp]), cur, self.q_mods)
                acc = term if acc is None else addmod(acc, term, self.q_mods)
                if comp + 1 < size:
                    cur = mulmod(cur, s_ntt, self.q_mods)
            dot = addmod(ct[:, 0], self._intt_q(acc), self.q_mods)
            return self._exact_round(mulmod(dot, self.q_hat_inv, self.q_mods))
        return f

    def decrypt_batch(self, cts: torch.Tensor, sk: SecretKey,
                      target_batch: Optional[int] = None) -> torch.Tensor:
        """Batched decrypt: (B, size, k, n) -> (B, n) mod-t polynomials on
        the engine's device.

        target_batch (>= B): pad the batch on the device (pad_rows) to a
        fixed size; rows >= B of the result are garbage the caller ignores."""
        size = int(cts.shape[1])
        fn = self._decrypt_fn(size)
        if target_batch is not None:
            cts = pad_rows(cts, target_batch)
        s_ntt = convert.secret_key_from_numpy(sk.s_ntt, self.device,
                                              self.params)
        return fn(cts, s_ntt)

    # ==================================================================
    # batched deterministic encryption (device math, host sampling)
    # ==================================================================
    def _encrypt_core(self, u_rns: torch.Tensor, e0_rns: torch.Tensor,
                      e1_rns: torch.Tensor, m: torch.Tensor,
                      pk_ct: torch.Tensor) -> torch.Tensor:
        """u/e*: (B, k, n) lifted signed samples; m: (B, n) mod t;
        pk_ct: (2, k, n) = first k limbs of the public key (NTT form)."""
        u_ntt = self._ntt_q(u_rns)
        c0 = self._intt_q(mulmod(u_ntt, pk_ct[0], self.q_mods))
        c1 = self._intt_q(mulmod(u_ntt, pk_ct[1], self.q_mods))
        dm = self._scaled_plain(m)
        c0 = addmod(addmod(c0, e0_rns, self.q_mods), dm, self.q_mods)
        c1 = addmod(c1, e1_rns, self.q_mods)
        return torch.stack([c0, c1], dim=1)

    def _sample_randomness(self, seeds):
        """Host sampling for ``encrypt_batch``: the ternary u and the two
        noise polynomials of every seed, lifted mod each ciphertext prime:
        three uint64 arrays (B, k, n)."""
        B, n, k = len(seeds), self.n, self.k
        u = np.empty((B, n), dtype=np.int64)
        e0 = np.empty((B, n), dtype=np.int64)
        e1 = np.empty((B, n), dtype=np.int64)
        for i in range(B):
            u[i] = sample_ternary(Blake2Xof(seeds[i], DOMAIN_TERNARY), n)
            xof_e = Blake2Xof(seeds[i], DOMAIN_ERROR)
            e0[i] = sample_cbd(xof_e, n)
            e1[i] = sample_cbd(xof_e, n)
        mods = np.array(self.golden.q_mods, dtype=np.int64).reshape(1, k, 1)
        return tuple(np.mod(x[:, None, :], mods).astype(np.uint64)
                     for x in (u, e0, e1))

    def encrypt_batch(self, plains: np.ndarray, pk: PublicKey, seeds,
                      target_batch: Optional[int] = None) -> torch.Tensor:
        """Deterministic batched encrypt: (B, n) mod-t polys -> (B, 2, k, n).

        Bit-identical to golden ``BfvContext.encrypt`` per element.  Sampling
        runs on the host, as in the reference.  target_batch (>= B): pad on
        the device after the transfer; rows >= B of the result are garbage
        the caller ignores."""
        dev = self.device
        T = plains.shape[0] if target_batch is None else target_batch
        u, e0, e1 = (pad_rows(convert.from_numpy(x, dev), T)
                     for x in self._sample_randomness(seeds))
        m = pad_rows(convert.plaintexts_from_numpy(
            np.asarray(plains).astype(np.uint64), dev, self.params), T)
        pk_ct = convert.public_key_from_numpy(pk.data, dev, self.params,
                                              ct_limbs_only=True)
        return self._encrypt_core(u, e0, e1, m, pk_ct)

    # ==================================================================
    # single-ciphertext protocol (host glue)
    # ==================================================================
    def _wrap(self, data: torch.Tensor) -> Ciphertext:
        return Ciphertext(self.params, convert.to_numpy(data))

    def _ct(self, ct: Ciphertext) -> torch.Tensor:
        return convert.ciphertexts_from_numpy(ct.data[None], self.device)

    def _rk(self, rk: RelinKeys) -> torch.Tensor:
        return convert.relin_keys_from_numpy(rk.data, self.device)

    def _plain(self, plain: np.ndarray) -> torch.Tensor:
        return convert.plaintexts_from_numpy(
            np.asarray(plain, dtype=np.uint64)[None], self.device,
            self.params)

    def _ext_addsub(self, a: Ciphertext, b: Ciphertext,
                    is_sub: bool) -> Ciphertext:
        """SEAL zero-extension add/sub for any component counts (mirrors
        golden._ext_addsub bit-exactly): shared components combine, the
        larger operand's extra components are copied, negated when they come
        from the subtrahend."""
        sa, sb = a.size, b.size
        if min(sa, sb) < 1:
            raise ValueError("add/sub expects ciphertexts with >= 1 "
                             "component")
        fn = self._sub if is_sub else self._add
        ta, tb = self._ct(a)[0], self._ct(b)[0]
        if sa == sb:
            return self._wrap(fn(ta, tb))
        m = min(sa, sb)
        shared = fn(ta[:m], tb[:m])
        if sa > sb:
            extra = ta[m:]
        else:
            extra = self._neg(tb[m:]) if is_sub else tb[m:]
        return self._wrap(torch.cat([shared, extra], dim=0))

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ext_addsub(a, b, False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ext_addsub(a, b, True)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return self._wrap(self._neg(self._ct(a))[0])

    def add_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        return self._wrap(self._add_plain(self._ct(a), self._plain(plain))[0])

    def sub_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        return self._wrap(self._sub_plain(self._ct(a), self._plain(plain))[0])

    def plain_sub(self, plain: np.ndarray, a: Ciphertext) -> Ciphertext:
        return self._wrap(self._plain_sub(self._plain(plain), self._ct(a))[0])

    def mul_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        return self._wrap(self._mul_plain(self._ct(a), self._plain(plain))[0])

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

    def encrypt(self, plain: np.ndarray, pk: PublicKey,
                seed: bytes) -> Ciphertext:
        out = self.encrypt_batch(np.asarray(plain, dtype=np.uint64)[None],
                                 pk, [seed])
        return self._wrap(out[0])

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> np.ndarray:
        return convert.to_numpy(self.decrypt_batch(self._ct(ct), sk)[0])

"""Canonical BFV implementation (host golden model, numpy uint64).

The benchmark's frozen copy of the golden model: key generation,
deterministic public-key encryption, decryption, the noise-budget meter, the
elementwise operations (SEAL's zero-extension for add/sub included), BEHZ
full-RNS ciphertext multiplication and SEAL-convention relinearization / key
switching.

Every operation here defines the *canonical byte semantics*: the benchmark
holds the results of the program under test to these arrays word for word.
This copy imports nothing of the program; only the benchmark's own files
import it.

Conventions (SEAL-compatible, verified against SEAL key blobs):
  * ciphertexts: coefficient form, RNS base = ct_moduli (special prime dropped)
  * public key / relin keys: NTT form, RNS base = all key moduli
  * secret key: NTT form per key modulus of a ternary polynomial
  * NTT: negacyclic, minimal primitive 2n-th root, bit-reversed layout
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .params import Params
from .sampling import (Blake2Xof, DOMAIN_ERROR, DOMAIN_KEYGEN,
                        DOMAIN_TERNARY, DOMAIN_UNIFORM, sample_cbd,
                        sample_ternary, sample_uniform_mod)
from .modmath import addmod, get_ntt_tables, invmod, mulmod, negmod, submod
from .ntt import intt, ntt


@dataclasses.dataclass
class SecretKey:
    params: Params
    s_ntt: np.ndarray           # uint64 (k_key, n), NTT form

    @property
    def s_coeff(self) -> np.ndarray:
        """Ternary coefficients as int64 (derived from limb 0)."""
        p = self.params.key_moduli[0]
        tb = get_ntt_tables(p, self.params.n)
        s = intt(self.s_ntt[0], tb)
        return np.where(s > np.uint64(p // 2),
                        s.astype(np.int64) - np.int64(p), s.astype(np.int64))


@dataclasses.dataclass
class RelinKeys:
    params: Params
    data: np.ndarray            # uint64 (k_ct, 2, k_key, n), NTT form


@dataclasses.dataclass
class PublicKey:
    """Encryption key + the relinearization keys that ride along in
    calldata; galois keys are intentionally absent."""

    params: Params
    data: np.ndarray            # uint64 (2, k_key, n), NTT form
    relin: Optional[RelinKeys] = None


@dataclasses.dataclass
class Ciphertext:
    params: Params
    data: np.ndarray            # uint64 (size, k_ct, n), coefficient form

    @property
    def size(self) -> int:
        return self.data.shape[0]


def _random_seed() -> bytes:
    return os.urandom(64)


class BfvContext:
    """Precomputed tables + all BFV operations for one parameter set.

    The analog of SEAL's SEALContext + Evaluator/Encryptor/Decryptor
    (constructed once per params).
    """

    def __init__(self, params: Params):
        params.validate()
        self.params = params
        n, t = params.n, params.t
        self.n, self.t = n, t
        self.q_mods = list(params.ct_moduli)
        self.key_mods = list(params.key_moduli)
        self.k = len(self.q_mods)
        self.k_key = len(self.key_mods)
        self.q = params.q

        self.tables = {p: get_ntt_tables(p, n) for p in
                       set(self.key_mods) | set(params.bsk_moduli)}

        # Δ-scaling constants: round(q*v/t) mod q_j = (Δ mod q_j)*v + fix(v)
        # with fix(v) = floor(((q mod t)*v + t//2)/t) < t  (exact identity,
        # since q*v + t//2 = Δ*t*v + (q mod t)*v + t//2).
        self.delta_mod_q = np.array([params.delta % p for p in self.q_mods],
                                    dtype=np.uint64)
        self.q_mod_t = self.q % t

        # CRT composition for decrypt: q_hat_i = q/q_i, garner-style
        self.q_hat = [self.q // p for p in self.q_mods]
        self.q_hat_inv = [invmod(self.q_hat[i] % p, p)
                          for i, p in enumerate(self.q_mods)]

        # ---- key switching (divide by special prime P) -------------------
        if params.special_modulus is not None:
            P = params.special_modulus
            self.P = P
            self.P_half = P >> 1
            self.inv_P_mod_q = [invmod(P % p, p) for p in self.q_mods]
            self.P_mod_q = [P % p for p in self.q_mods]

        # ---- BEHZ multiply precomputations -------------------------------
        self.B = list(params.aux_moduli)
        self.m_sk = params.m_sk
        self.m_tilde = params.m_tilde
        self.Bsk = self.B + [self.m_sk]
        mt = self.m_tilde

        # FastBconv q -> Bsk ∪ {m_tilde}
        self.q_hat_mod_x = {
            x: np.array([self.q_hat[i] % x for i in range(self.k)],
                        dtype=np.uint64)
            for x in self.Bsk + [mt]}
        self.q_mod_x = {x: self.q % x for x in self.Bsk}
        self.mtilde_mod_q = [mt % p for p in self.q_mods]
        self.neg_inv_q_mod_mtilde = (-invmod(self.q % mt, mt)) % mt
        self.inv_mtilde_mod_x = {x: invmod(mt % x, x) for x in self.Bsk}
        self.inv_q_mod_x = {x: invmod(self.q % x, x) for x in self.Bsk}

        # FastBconvSK: B -> q (+ m_sk correction)
        prod_B = math.prod(self.B)
        self.prod_B = prod_B
        self.b_hat = [prod_B // b for b in self.B]
        self.b_hat_inv = [invmod(self.b_hat[i] % b, b)
                          for i, b in enumerate(self.B)]
        self.b_hat_mod_x = {
            x: np.array([h % x for h in self.b_hat], dtype=np.uint64)
            for x in self.q_mods + [self.m_sk]}
        self.prod_B_mod_q = [prod_B % p for p in self.q_mods]
        self.inv_prod_B_mod_msk = invmod(prod_B % self.m_sk, self.m_sk)

    # ------------------------------------------------------------------
    # sampling helpers
    # ------------------------------------------------------------------
    def _rns_from_signed(self, poly: np.ndarray,
                         mods: Sequence[int]) -> np.ndarray:
        out = np.empty((len(mods), self.n), dtype=np.uint64)
        for j, p in enumerate(mods):
            out[j] = np.mod(poly, np.int64(p)).astype(np.uint64)
        return out

    def _scale_plain(self, plain: np.ndarray) -> np.ndarray:
        """round(q*m/t) mod each q_j for a mod-t poly: (n,) -> (k, n)."""
        m = np.asarray(plain, dtype=np.uint64)
        t = np.uint64(self.t)
        fix = (np.uint64(self.q_mod_t) * m + t // np.uint64(2)) // t
        out = np.empty((self.k, m.shape[-1]), dtype=np.uint64)
        for j, p in enumerate(self.q_mods):
            out[j] = addmod(mulmod(np.uint64(self.delta_mod_q[j]), m, p),
                            fix, p)
        return out

    # ------------------------------------------------------------------
    # key generation
    # ------------------------------------------------------------------
    def generate_keys(self, seed: Optional[bytes] = None,
                      relin: bool = True) -> Tuple[PublicKey, SecretKey]:
        """Keygen; galois keys are intentionally never produced (no
        rotation support)."""
        seed = seed if seed is not None else _random_seed()
        n = self.n
        xof_s = Blake2Xof(seed, DOMAIN_KEYGEN)
        s = sample_ternary(xof_s, n)
        s_ntt = np.empty((self.k_key, n), dtype=np.uint64)
        for i, p in enumerate(self.key_mods):
            s_ntt[i] = ntt(np.mod(s, np.int64(p)).astype(np.uint64),
                           self.tables[p])
        sk = SecretKey(self.params, s_ntt)

        xof_a = Blake2Xof(seed, DOMAIN_UNIFORM)
        xof_e = Blake2Xof(seed, DOMAIN_ERROR)
        pk = np.empty((2, self.k_key, n), dtype=np.uint64)
        e = sample_cbd(xof_e, n)
        for i, p in enumerate(self.key_mods):
            a = sample_uniform_mod(xof_a, p, n)          # NTT-form uniform
            e_ntt = ntt(np.mod(e, np.int64(p)).astype(np.uint64),
                        self.tables[p])
            pk[0, i] = negmod(addmod(mulmod(a, s_ntt[i], p), e_ntt, p), p)
            pk[1, i] = a
        public = PublicKey(self.params, pk)

        if relin and self.params.special_modulus is not None:
            public.relin = self._generate_relin_keys(sk, xof_a, xof_e)
        return public, sk

    def _generate_relin_keys(self, sk: SecretKey, xof_a: Blake2Xof,
                             xof_e: Blake2Xof) -> RelinKeys:
        """SEAL-convention relin keys: key_j = enc_zero + P*s^2 on limb j.

        Matches SEAL's generate_one_kswitch_key so that SEAL relin-key
        blobs (inside network.pub) are interchangeable with ours.
        """
        n = self.n
        s_ntt = sk.s_ntt
        rk = np.empty((self.k, 2, self.k_key, n), dtype=np.uint64)
        for j in range(self.k):
            e = sample_cbd(xof_e, n)
            for i, p in enumerate(self.key_mods):
                a = sample_uniform_mod(xof_a, p, n)
                e_ntt = ntt(np.mod(e, np.int64(p)).astype(np.uint64),
                            self.tables[p])
                rk[j, 0, i] = negmod(
                    addmod(mulmod(a, s_ntt[i], p), e_ntt, p), p)
                rk[j, 1, i] = a
            # embed P * s^2 into decomposition limb j
            pj = self.q_mods[j]
            s2 = mulmod(s_ntt[j], s_ntt[j], pj)
            term = mulmod(s2, np.uint64(self.P % pj), pj)
            rk[j, 0, j] = addmod(rk[j, 0, j], term, pj)
        return RelinKeys(self.params, rk)

    # ------------------------------------------------------------------
    # encryption / decryption
    # ------------------------------------------------------------------
    def encrypt(self, plain: np.ndarray, pk: PublicKey,
                seed: Optional[bytes] = None) -> Ciphertext:
        """Public-key encryption of a mod-t coefficient polynomial.

        Deterministic given `seed` (the consensus requirement): same
        (plain, seed, pk) => identical ciphertext bytes.
        """
        seed = seed if seed is not None else _random_seed()
        n = self.n
        u = sample_ternary(Blake2Xof(seed, DOMAIN_TERNARY), n)
        xof_e = Blake2Xof(seed, DOMAIN_ERROR)
        e0 = sample_cbd(xof_e, n)
        e1 = sample_cbd(xof_e, n)
        return self.encrypt_with_randomness(plain, pk, u, e0, e1)

    def encrypt_with_randomness(self, plain: np.ndarray, pk: PublicKey,
                                u: np.ndarray, e0: np.ndarray,
                                e1: np.ndarray) -> Ciphertext:
        """Public-key encryption with caller-supplied randomness polynomials
        (signed int64: u ternary, e0/e1 noise); algebra = SEAL's
        encrypt_zero_asymmetric +
        multiply_add_plain_with_scaling_variant, which is exact modular
        arithmetic, so identical randomness => identical ciphertext words."""
        n = self.n
        plain_idx = np.asarray(plain, dtype=np.uint64)

        dm = self._scale_plain(plain_idx)                # round(q*m/t) mod q_j
        ct = np.empty((2, self.k, n), dtype=np.uint64)
        for j, p in enumerate(self.q_mods):
            tb = self.tables[p]
            u_ntt = ntt(np.mod(u, np.int64(p)).astype(np.uint64), tb)
            c0 = intt(mulmod(u_ntt, pk.data[0, j], p), tb)
            c1 = intt(mulmod(u_ntt, pk.data[1, j], p), tb)
            e0_r = np.mod(e0, np.int64(p)).astype(np.uint64)
            e1_r = np.mod(e1, np.int64(p)).astype(np.uint64)
            ct[0, j] = addmod(addmod(c0, e0_r, p), dm[j], p)
            ct[1, j] = addmod(c1, e1_r, p)
        return Ciphertext(self.params, ct)

    def _dot_with_secret(self, ct: Ciphertext, sk: SecretKey) -> np.ndarray:
        """c0 + c1*s + c2*s^2 + ... mod each ct modulus, coefficient form.

        c0 stays in coefficient form (INTT(NTT(c0) + X) == c0 + INTT(X)
        exactly), saving one forward transform per limb, bit-identical
        output.
        """
        n = self.n
        out = np.empty((self.k, n), dtype=np.uint64)
        for j, p in enumerate(self.q_mods):
            tb = self.tables[p]
            acc = None
            s_ntt = sk.s_ntt[j]
            cur = s_ntt
            for comp in range(1, ct.size):
                term = mulmod(ntt(ct.data[comp, j].copy(), tb), cur, p)
                acc = term if acc is None else addmod(acc, term, p)
                if comp + 1 < ct.size:
                    cur = mulmod(cur, s_ntt, p)
            out[j] = addmod(ct.data[0, j], intt(acc, tb), p)
        return out

    def _message_from_dot(self, dot: np.ndarray) -> np.ndarray:
        """CRT-compose dot residues to x in [0, q), then round(t*x/q) mod t."""
        x = np.zeros(dot.shape[-1], dtype=object)
        for j, p in enumerate(self.q_mods):
            y = mulmod(dot[j], np.uint64(self.q_hat_inv[j]), p).astype(object)
            x += y * self.q_hat[j]
        x %= self.q
        t, q = self.t, self.q
        m = (t * x + q // 2) // q % t
        return m.astype(np.uint64)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> np.ndarray:
        """Returns the plaintext polynomial mod t (exact CRT scale-and-round)."""
        return self._message_from_dot(self._dot_with_secret(ct, sk))

    def noise_budget_bits(self, ct: Ciphertext, sk: SecretKey) -> float:
        """log2(q / (2*|noise|)) -- observability metric (SURVEY.md section 5).

        The noise magnitude is computed division-free: noise residues are
        formed in RNS (dot - round(q*m/t) per limb, all uint64 vectorized),
        then CRT-composed with 128-bit numpy arithmetic (q < 2**111) and
        centered -- no per-coefficient big-int loops.
        """
        from . import uint128 as u128
        dot = self._dot_with_secret(ct, sk)
        m = self._message_from_dot(dot)
        dm = self._scale_plain(m)                 # round(q*m/t) mod q_j
        q = self.q
        acc = u128.zeros(self.n)
        for j, p in enumerate(self.q_mods):
            noise_j = submod(dot[j], dm[j], p)
            y = mulmod(noise_j, np.uint64(self.q_hat_inv[j]), p)
            acc = u128.add(acc, u128.mul_const(y, self.q_hat[j]))
        q128 = u128.from_int(q, self.n)
        for _ in range(self.k - 1):
            over = u128.geq(acc, q128)
            acc = u128.select(over, u128.sub(acc, q128), acc)
        # centered magnitude: min(x, q - x)
        flip = u128.sub(q128, acc)
        half = u128.from_int(q // 2, self.n)
        centered = u128.select(u128.geq(half, acc), acc, flip)
        worst = max(1, u128.max_value(centered))
        return math.log2(q) - 1 - math.log2(worst)

    # ------------------------------------------------------------------
    # homomorphic ops
    # ------------------------------------------------------------------
    def _ext_addsub(self, a: Ciphertext, b: Ciphertext, fn,
                    neg_extra: bool) -> Ciphertext:
        """SEAL Evaluator::add/sub semantics for ANY component counts:
        result size = max(sa, sb); shared components combine; the larger
        operand's extra components are copied (negated when they come
        from the subtrahend).  The wire accepts any size >= 1, so all
        engines must agree here."""
        sa, sb = a.size, b.size
        if min(sa, sb) < 1:
            raise ValueError("add/sub expects ciphertexts with >= 1 "
                             "component")
        m, big = min(sa, sb), max(sa, sb)
        out = np.empty((big, self.k, self.n), dtype=np.uint64)
        for j, p in enumerate(self.q_mods):
            out[:m, j] = fn(a.data[:m, j], b.data[:m, j], p)
            if sa > sb:
                out[m:, j] = a.data[m:, j]
            elif sb > sa:
                out[m:, j] = (negmod(b.data[m:, j], p) if neg_extra
                              else b.data[m:, j])
        return Ciphertext(self.params, out)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ext_addsub(a, b, addmod, False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ext_addsub(a, b, submod, True)

    def negate(self, a: Ciphertext) -> Ciphertext:
        out = np.empty_like(a.data)
        for j, p in enumerate(self.q_mods):
            out[:, j] = negmod(a.data[:, j], p)
        return Ciphertext(self.params, out)

    def add_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        out = a.data.copy()
        dm = self._scale_plain(plain)
        for j, p in enumerate(self.q_mods):
            out[0, j] = addmod(out[0, j], dm[j], p)
        return Ciphertext(self.params, out)

    def sub_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        out = a.data.copy()
        dm = self._scale_plain(plain)
        for j, p in enumerate(self.q_mods):
            out[0, j] = submod(out[0, j], dm[j], p)
        return Ciphertext(self.params, out)

    def plain_sub(self, plain: np.ndarray, a: Ciphertext) -> Ciphertext:
        """plain - ct  =  -(ct - plain)."""
        return self.negate(self.sub_plain(a, plain))

    def mul_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        """ct * pt: negacyclic product of every component with the plain poly."""
        out = np.empty_like(a.data)
        for j, p in enumerate(self.q_mods):
            tb = self.tables[p]
            m_ntt = ntt(np.asarray(plain, dtype=np.uint64) % np.uint64(p), tb)
            for comp in range(a.size):
                out[comp, j] = intt(
                    mulmod(ntt(a.data[comp, j].copy(), tb), m_ntt, p), tb)
        return Ciphertext(self.params, out)

    # ------------------------------------------------------------------
    # BEHZ full-RNS ciphertext multiplication
    # ------------------------------------------------------------------
    def _fastbconv_q(self, poly_q: np.ndarray, targets: Sequence[int]
                     ) -> np.ndarray:
        """FastBconv from base q to `targets`: sum_i [x*q_hat_inv]_{q_i} * q_hat_i."""
        ys = [mulmod(poly_q[i], np.uint64(self.q_hat_inv[i]), self.q_mods[i])
              for i in range(self.k)]
        out = np.zeros((len(targets), poly_q.shape[-1]), dtype=np.uint64)
        for xi, x in enumerate(targets):
            acc = np.zeros(poly_q.shape[-1], dtype=np.uint64)
            hats = self.q_hat_mod_x[x]
            for i in range(self.k):
                acc = addmod(acc, mulmod(ys[i], hats[i], x), x)
            out[xi] = acc
        return out

    def _to_bsk(self, poly_q: np.ndarray) -> np.ndarray:
        """Exact-ish lift of a base-q poly into Bsk via m_tilde Montgomery trick.

        Output residues represent c + alpha*q with small |alpha|; all Bsk
        residues are consistent with that single lifted integer (BEHZ steps
        1-2: FastBconv + SmMRq).
        """
        mt = self.m_tilde
        # multiply input by m_tilde in base q
        scaled = np.stack([
            mulmod(poly_q[i], np.uint64(self.mtilde_mod_q[i]), self.q_mods[i])
            for i in range(self.k)])
        conv = self._fastbconv_q(scaled, self.Bsk + [mt])
        c_mt = conv[-1]
        r = mulmod(c_mt, np.uint64(self.neg_inv_q_mod_mtilde), mt)
        # center r in (-mt/2, mt/2]
        r_int = r.astype(np.int64)
        r_c = np.where(r_int > mt // 2, r_int - mt, r_int)
        out = np.empty((len(self.Bsk), poly_q.shape[-1]), dtype=np.uint64)
        for xi, x in enumerate(self.Bsk):
            rm = np.mod(r_c, np.int64(x)).astype(np.uint64)
            num = addmod(conv[xi], mulmod(np.uint64(self.q_mod_x[x]), rm, x), x)
            out[xi] = mulmod(num, np.uint64(self.inv_mtilde_mod_x[x]), x)
        return out

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """BEHZ ct*ct tensor + scale: (c0,c1)x(c0',c1') -> size-3 ciphertext."""
        if a.size != 2 or b.size != 2:
            raise ValueError("multiply expects size-2 ciphertexts")
        n = self.n
        bases = self.q_mods + self.Bsk
        nb = len(bases)

        # residues of all 4 polys in all bases (q: native, Bsk: lifted)
        def extend(ct: Ciphertext) -> np.ndarray:
            out = np.empty((2, nb, n), dtype=np.uint64)
            for comp in range(2):
                out[comp, :self.k] = ct.data[comp]
                out[comp, self.k:] = self._to_bsk(ct.data[comp])
            return out

        ea, eb = extend(a), extend(b)

        # tensor products per base (NTT domain)
        prod = np.empty((3, nb, n), dtype=np.uint64)
        for xi, p in enumerate(bases):
            tb = self.tables[p]
            a0 = ntt(ea[0, xi].copy(), tb)
            a1 = ntt(ea[1, xi].copy(), tb)
            b0 = ntt(eb[0, xi].copy(), tb)
            b1 = ntt(eb[1, xi].copy(), tb)
            prod[0, xi] = intt(mulmod(a0, b0, p), tb)
            prod[1, xi] = intt(addmod(mulmod(a0, b1, p),
                                      mulmod(a1, b0, p), p), tb)
            prod[2, xi] = intt(mulmod(a1, b1, p), tb)

        # FastFloor: floor(t * prod / q), result in Bsk
        out = np.empty((3, self.k, n), dtype=np.uint64)
        t64 = np.uint64(self.t)
        for comp in range(3):
            tq = np.stack([mulmod(prod[comp, i], t64, bases[i])
                           for i in range(nb)])
            conv = self._fastbconv_q(tq[:self.k], self.Bsk)
            floor_bsk = np.empty((len(self.Bsk), n), dtype=np.uint64)
            for xi, x in enumerate(self.Bsk):
                num = submod(tq[self.k + xi], conv[xi], x)
                floor_bsk[xi] = mulmod(num, np.uint64(self.inv_q_mod_x[x]), x)
            out[comp] = self._fastbconv_sk(floor_bsk)
        return Ciphertext(self.params, out)

    def _fastbconv_sk(self, poly_bsk: np.ndarray) -> np.ndarray:
        """Shenoy-Kumaresan exact conversion Bsk -> q."""
        nB = len(self.B)
        ys = [mulmod(poly_bsk[i], np.uint64(self.b_hat_inv[i]), self.B[i])
              for i in range(nB)]
        msk = self.m_sk
        # alpha correction via m_sk
        acc = np.zeros(poly_bsk.shape[-1], dtype=np.uint64)
        hats_msk = self.b_hat_mod_x[msk]
        for i in range(nB):
            acc = addmod(acc, mulmod(ys[i], hats_msk[i], msk), msk)
        alpha = mulmod(submod(acc, poly_bsk[nB], msk),
                       np.uint64(self.inv_prod_B_mod_msk), msk)
        alpha_i = alpha.astype(np.int64)
        alpha_c = np.where(alpha_i > msk // 2, alpha_i - msk, alpha_i)

        out = np.empty((self.k, poly_bsk.shape[-1]), dtype=np.uint64)
        for qi, p in enumerate(self.q_mods):
            accq = np.zeros(poly_bsk.shape[-1], dtype=np.uint64)
            hats = self.b_hat_mod_x[p]
            for i in range(nB):
                accq = addmod(accq, mulmod(ys[i], hats[i], p), p)
            corr = mulmod(np.mod(alpha_c, np.int64(p)).astype(np.uint64),
                          np.uint64(self.prod_B_mod_q[qi]), p)
            out[qi] = submod(accq, corr, p)
        return out

    # ------------------------------------------------------------------
    # relinearization / key switching
    # ------------------------------------------------------------------
    def relinearize(self, ct: Ciphertext, rk: RelinKeys) -> Ciphertext:
        """Size-3 -> size-2 via SEAL-convention RNS-decomposition keyswitch."""
        if ct.size != 3:
            raise ValueError("relinearize expects a size-3 ciphertext")
        n = self.n
        c2 = ct.data[2]

        acc = np.zeros((2, self.k_key, n), dtype=np.uint64)
        for j in range(self.k):
            dj = c2[j]                                   # values < q_j < 2**37
            for i, p in enumerate(self.key_mods):
                dji = ntt(dj % np.uint64(p), self.tables[p])
                acc[0, i] = addmod(acc[0, i],
                                   mulmod(dji, rk.data[j, 0, i], p), p)
                acc[1, i] = addmod(acc[1, i],
                                   mulmod(dji, rk.data[j, 1, i], p), p)
        for i, p in enumerate(self.key_mods):
            tb = self.tables[p]
            acc[0, i] = intt(acc[0, i], tb)
            acc[1, i] = intt(acc[1, i], tb)

        # divide by P = special prime, with rounding
        out = np.empty((2, self.k, n), dtype=np.uint64)
        P, half = self.P, self.P_half
        for comp in range(2):
            xP = acc[comp, self.k_key - 1]
            xP_half = addmod(xP, np.uint64(half), P)
            for i, p in enumerate(self.q_mods):
                corr = submod(np.mod(xP_half, np.uint64(p)),
                              np.uint64(half % p), p)
                ti = submod(acc[comp, i], corr, p)
                out[comp, i] = mulmod(ti, np.uint64(self.inv_P_mod_q[i]), p)
        res = out
        res[0] = np.stack([addmod(ct.data[0, i], res[0, i], p)
                           for i, p in enumerate(self.q_mods)])
        res[1] = np.stack([addmod(ct.data[1, i], res[1, i], p)
                           for i, p in enumerate(self.q_mods)])
        return Ciphertext(self.params, res)

    def mul_relin(self, a: Ciphertext, b: Ciphertext,
                  rk: RelinKeys) -> Ciphertext:
        return self.relinearize(self.multiply(a, b), rk)

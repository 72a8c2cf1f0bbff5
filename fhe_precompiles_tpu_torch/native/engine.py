"""NativeEngine: ctypes binding of the C++ host engine
(``native/host_engine.cpp``), the CPU validator's engine.

The port's counterpart of ``fhe_precompiles_tpu/native/engine.py``, over the
port's copy of the same C++ source (byte for byte), built by ``ops/build.py``
``build_host_engine`` into ``_build/libhost_engine.so``.  Bit-identical to
``bfv/golden.py``, keygen included (tests/test_torch_native_engine.py).  It
implements the ``FheApp`` engine protocol, so ``FheApp(params,
engine="native")`` serves the 49 precompiles on the CPU: the engine that
validators without a card run, whose bytes the card's must equal.  It
launches no kernel and touches no device.

Division of labor: polynomial/RNS math runs in C++ (the part SEAL does in
C++ for the reference); sampling (Blake2b XOF) and serialization stay in
Python -- hashlib is already C-speed and both are consensus-pinned there.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..bfv.golden import BfvContext, Ciphertext, PublicKey, RelinKeys, SecretKey
from ..ops import build as _build
from ..params import Params
from ..sampling import (CBD_K, DOMAIN_ERROR, DOMAIN_KEYGEN, DOMAIN_TERNARY,
                        DOMAIN_UNIFORM)

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)

_lib = None


def _load():
    """The engine library with its signatures, built first where its
    source changed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build_host_engine()))
        lib.he_ctx_new.restype = ctypes.c_void_p
        lib.he_ctx_new.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64,
            _U64P, ctypes.c_uint64, _U64P, ctypes.c_uint64,
            _U64P, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
        lib.he_ctx_free.argtypes = [ctypes.c_void_p]
        for name, args in {
            "he_add": [ctypes.c_void_p, _U64P, _U64P, ctypes.c_uint64, _U64P],
            "he_sub": [ctypes.c_void_p, _U64P, _U64P, ctypes.c_uint64, _U64P],
            "he_neg": [ctypes.c_void_p, _U64P, ctypes.c_uint64, _U64P],
            "he_plain_affine": [ctypes.c_void_p, _U64P, ctypes.c_uint64,
                                _U64P, ctypes.c_int, _U64P],
            "he_mul_plain": [ctypes.c_void_p, _U64P, ctypes.c_uint64,
                             _U64P, _U64P],
            "he_encrypt": [ctypes.c_void_p, _U64P, _I64P, _I64P, _I64P,
                           _U64P, ctypes.c_uint64, _U64P],
            "he_decrypt": [ctypes.c_void_p, _U64P, ctypes.c_uint64,
                           _U64P, _U64P],
            "he_multiply": [ctypes.c_void_p, _U64P, _U64P, _U64P],
            "he_relinearize": [ctypes.c_void_p, _U64P, _U64P, _U64P],
            "he_sample_ternary": [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint64, _I64P],
            "he_sample_cbd_pair": [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_uint64,
                                   _I64P, _I64P],
            "he_keygen": [ctypes.c_void_p, ctypes.c_char_p,
                          ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                          ctypes.c_uint64, ctypes.c_int,
                          _U64P, _U64P, _U64P],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
    return _lib


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _c(a: np.ndarray, dtype=np.uint64) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


class NativeEngine:
    """C++ host engine bound to one parameter set (FheApp engine protocol)."""

    def __init__(self, params: Params, golden: Optional[BfvContext] = None):
        self.params = params
        self.golden = golden if golden is not None else BfvContext(params)
        g = self.golden
        self.n, self.k, self.k_key = g.n, g.k, g.k_key
        if tuple(g.key_mods[:g.k]) != tuple(g.q_mods):
            raise ValueError("ct moduli must be a prefix of key moduli")
        lib = _load()
        qm = _c(np.array(g.q_mods))
        km = _c(np.array(g.key_mods))
        aux = _c(np.array(g.B))
        self._ctx = lib.he_ctx_new(
            g.n, g.t, _u64p(qm), len(g.q_mods), _u64p(km), len(g.key_mods),
            _u64p(aux), len(g.B), g.m_sk, g.m_tilde)
        if not self._ctx:
            raise ValueError(
                "parameter set outside the native engine's supported range "
                "(k <= 4 limbs, moduli < 2**37, q < 2**122)")
        self._lib = lib

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.he_ctx_free(ctx)
            self._ctx = None

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _wrap(self, data: np.ndarray) -> Ciphertext:
        return Ciphertext(self.params, data)

    def _out(self, size: int) -> np.ndarray:
        return np.empty((size, self.k, self.n), dtype=np.uint64)

    def _plain(self, m: np.ndarray) -> np.ndarray:
        return _c(np.asarray(m))

    # ------------------------------------------------------------------
    # homomorphic ops (bit-identical to BfvContext methods)
    # ------------------------------------------------------------------
    def _ext_addsub(self, a: Ciphertext, b: Ciphertext,
                    is_sub: bool) -> Ciphertext:
        """SEAL zero-extension add/sub (golden._ext_addsub semantics):
        the C++ kernel runs on the shared prefix (bounded raw-buffer
        indexing), extras are copied / he_neg'd on the Python side."""
        sa, sb = a.size, b.size
        if min(sa, sb) < 1:
            raise ValueError("add/sub expects ciphertexts with >= 1 "
                             "component")
        m, big = min(sa, sb), max(sa, sb)
        out = self._out(big)
        fn = self._lib.he_sub if is_sub else self._lib.he_add
        fn(self._ctx, _u64p(_c(a.data[:m])), _u64p(_c(b.data[:m])),
           m, _u64p(out))
        if sa > sb:
            out[m:] = a.data[m:]
        elif sb > sa:
            if is_sub:
                extra = np.ascontiguousarray(b.data[m:])
                self._lib.he_neg(self._ctx, _u64p(extra), sb - m,
                                 _u64p(out[m:]))
            else:
                out[m:] = b.data[m:]
        return self._wrap(out)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ext_addsub(a, b, False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._ext_addsub(a, b, True)

    def negate(self, a: Ciphertext) -> Ciphertext:
        out = self._out(a.size)
        self._lib.he_neg(self._ctx, _u64p(_c(a.data)), a.size, _u64p(out))
        return self._wrap(out)

    def _affine(self, a: Ciphertext, plain: np.ndarray, mode: int) -> Ciphertext:
        out = self._out(a.size)
        self._lib.he_plain_affine(self._ctx, _u64p(_c(a.data)), a.size,
                                  _u64p(self._plain(plain)), mode, _u64p(out))
        return self._wrap(out)

    def add_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        return self._affine(a, plain, 0)

    def sub_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        return self._affine(a, plain, 1)

    def plain_sub(self, plain: np.ndarray, a: Ciphertext) -> Ciphertext:
        return self._affine(a, plain, 2)

    def mul_plain(self, a: Ciphertext, plain: np.ndarray) -> Ciphertext:
        out = self._out(a.size)
        self._lib.he_mul_plain(self._ctx, _u64p(_c(a.data)), a.size,
                               _u64p(self._plain(plain)), _u64p(out))
        return self._wrap(out)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.size != 2 or b.size != 2:
            raise ValueError("multiply expects size-2 ciphertexts")
        out = self._out(3)
        self._lib.he_multiply(self._ctx, _u64p(_c(a.data)),
                              _u64p(_c(b.data)), _u64p(out))
        return self._wrap(out)

    def relinearize(self, ct: Ciphertext, rk: RelinKeys) -> Ciphertext:
        if ct.size != 3:
            raise ValueError("relinearize expects a size-3 ciphertext")
        want = (self.k, 2, self.k_key, self.n)
        if rk.data.shape != want:
            # he_relinearize indexes a dense block of this exact shape
            raise ValueError(f"relin keys shaped {rk.data.shape}, "
                             f"expected {want}")
        out = self._out(2)
        self._lib.he_relinearize(self._ctx, _u64p(_c(ct.data)),
                                 _u64p(_c(rk.data)), _u64p(out))
        return self._wrap(out)

    def mul_relin(self, a: Ciphertext, b: Ciphertext,
                  rk: RelinKeys) -> Ciphertext:
        return self.relinearize(self.multiply(a, b), rk)

    # ------------------------------------------------------------------
    # key generation (bit-identical to golden.generate_keys per seed)
    # ------------------------------------------------------------------
    def generate_keys(self, seed: Optional[bytes] = None, relin: bool = True):
        seed = seed if seed is not None else os.urandom(64)
        n, k, kk = self.n, self.k, self.k_key
        s_ntt = np.empty((kk, n), dtype=np.uint64)
        pk = np.empty((2, kk, n), dtype=np.uint64)
        want_rk = relin and self.params.special_modulus is not None
        rk = np.empty((k, 2, kk, n), dtype=np.uint64) if want_rk else None
        self._lib.he_keygen(
            self._ctx, seed, DOMAIN_KEYGEN, DOMAIN_UNIFORM, DOMAIN_ERROR,
            CBD_K, 1 if want_rk else 0, _u64p(s_ntt), _u64p(pk),
            _u64p(rk) if want_rk else None)
        public = PublicKey(self.params, pk)
        if want_rk:
            public.relin = RelinKeys(self.params, rk)
        return public, SecretKey(self.params, s_ntt)

    # ------------------------------------------------------------------
    # threshold-API protocol (host sampling, native polynomial math)
    # ------------------------------------------------------------------
    def encrypt(self, plain: np.ndarray, pk: PublicKey,
                seed: bytes) -> Ciphertext:
        n = self.n
        # Native BLAKE2b XOF samplers: byte-identical streams to
        # sampling.sample_ternary / sample_cbd (tests/
        # test_torch_native_engine.py pins the equality), ~10x the hashlib
        # block loop.
        u = np.empty(n, dtype=np.int64)
        e0 = np.empty(n, dtype=np.int64)
        e1 = np.empty(n, dtype=np.int64)
        self._lib.he_sample_ternary(seed, DOMAIN_TERNARY, n, _i64p(u))
        self._lib.he_sample_cbd_pair(seed, DOMAIN_ERROR, n, CBD_K,
                                     _i64p(e0), _i64p(e1))
        return self.encrypt_with_randomness(plain, pk, u, e0, e1)

    def encrypt_with_randomness(self, plain: np.ndarray, pk: PublicKey,
                                u: np.ndarray, e0: np.ndarray,
                                e1: np.ndarray) -> Ciphertext:
        if pk.data.shape[0] != 2 or pk.data.shape[1] < self.k \
                or pk.data.shape[2] != self.n:
            raise ValueError(f"public key shaped {pk.data.shape} unusable "
                             f"for k={self.k}, n={self.n}")
        out = self._out(2)
        self._lib.he_encrypt(
            self._ctx, _u64p(self._plain(plain)),
            _i64p(_c(u, np.int64)), _i64p(_c(e0, np.int64)),
            _i64p(_c(e1, np.int64)),
            _u64p(_c(pk.data)), pk.data.shape[1], _u64p(out))
        return self._wrap(out)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> np.ndarray:
        out = np.empty(self.n, dtype=np.uint64)
        s_ntt = _c(sk.s_ntt[:self.k])
        self._lib.he_decrypt(self._ctx, _u64p(_c(ct.data)), ct.size,
                             _u64p(s_ntt), _u64p(out))
        return out

"""Sunscreen-level key / ciphertext containers: bincode framing over SEAL blobs.

The port's own copy of ``fhe_precompiles_tpu/serialization/keyio.py``; its
``to_bytes`` / ``from_bytes`` are installed on the port's ``bfv/golden.py``
classes.  Byte-level parity targets:

* ``PublicKey`` file = bincode { WithContext { Params, Vec<u8> SEAL-PublicKey },
  Option<galois> (always None, fhe.rs:34-44), Option<relin>
  (Some WithContext { Params, Vec<u8> SEAL-RelinKeys }) } -- verified against
  the reference's ``src/data/network.pub`` and ``tests/data/public_key.bin``.
* ``PrivateKey`` file = bincode { WithContext { Params, Vec<u8> SEAL-SecretKey } }
  -- verified against ``network.pri`` / ``private_key.bin``.
* ``Params`` = { n u64, Vec<u64> coeff_modulus, t u64, scheme u32, security u32 }.

Ciphertext framing: the reference emits sunscreen's serde bincode of its
``Ciphertext`` struct (fhe.rs:29).  Without the sunscreen source its exact
field order cannot be byte-verified, so this framework defines a documented
container of the same family: bincode { Params, u64 blob_count, Vec<u8> SEAL
ciphertext stream ... }.  All framing lives in this one module.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..bfv.golden import Ciphertext, PublicKey, RelinKeys, SecretKey
from ..errors import invalid_encoding
from ..params import Params
from .bincode import Reader, Writer
from .seal import (SealCiphertextBlob, SealKSwitchKeysBlob, SealPlaintextBlob,
                   compute_parms_id)

_SCHEME_TAGS = {"bfv": 0}
_SECURITY_TAGS = {"tc128": 0}


def _check_parms_id(blob_id: bytes, params: Params, moduli, what: str) -> None:
    """SEAL validates the embedded parms_id against the context on load;
    mirror that so header corruption is rejected rather than ignored."""
    want = compute_parms_id(params.n, moduli, params.t)
    if bytes(blob_id) != want:
        raise invalid_encoding(f"{what} parms_id does not match parameters")


def _check_residue_range(data: np.ndarray, moduli, what: str) -> None:
    """Reject residues >= their modulus: out-of-range words are not valid
    wire data, and golden vs accelerated arithmetic only agree on canonical
    inputs (consensus requires rejecting them at the boundary)."""
    for j, m in enumerate(moduli):
        if data[..., j, :].max(initial=0) >= m:
            raise invalid_encoding(f"{what} residue exceeds modulus {m:#x}")


def read_params(r: Reader) -> Params:
    n = r.u64()
    count = r.u64()
    mods = tuple(r.u64() for _ in range(count))
    t = r.u64()
    scheme = r.u32()
    security = r.u32()
    if scheme != 0:
        raise invalid_encoding(f"unsupported scheme tag {scheme}")
    if security != 0:
        raise invalid_encoding(f"unsupported security tag {security}")
    params = Params(poly_modulus_degree=n, coeff_modulus=mods, plain_modulus=t)
    try:
        # untrusted bytes: enforce the arithmetic preconditions (moduli
        # < 2**37, NTT-friendly, power-of-two n) before anything computes
        params.validate()
    except ValueError as exc:
        raise invalid_encoding(str(exc)) from exc
    return params


def write_params(w: Writer, params: Params) -> None:
    w.u64(params.n)
    w.u64(len(params.coeff_modulus))
    for m in params.coeff_modulus:
        w.u64(m)
    w.u64(params.t)
    w.u32(_SCHEME_TAGS[params.scheme_type])
    w.u32(_SECURITY_TAGS[params.security_level])


# --------------------------------------------------------------------------
# PublicKey (+ embedded relin keys)
# --------------------------------------------------------------------------

def load_public_key(data: bytes) -> PublicKey:
    r = Reader(data)
    params = read_params(r)
    pk_stream = r.byte_vec()
    blob = SealCiphertextBlob.from_stream(pk_stream)
    if not blob.is_ntt_form or blob.size != 2:
        raise invalid_encoding("public key blob is not a size-2 NTT ciphertext")
    if blob.k != len(params.key_moduli) or blob.n != params.n:
        raise invalid_encoding("public key dimensions disagree with params")
    _check_parms_id(blob.parms_id, params, params.key_moduli, "public key")
    _check_residue_range(blob.data, params.key_moduli, "public key")
    pk = PublicKey(params, np.ascontiguousarray(blob.data, dtype=np.uint64))

    if r.option():
        # The reference's own keygen strips galois keys (fhe.rs:34-44) but
        # its deserializer would still accept a pk carrying them, so skip
        # the blob (WithContext { Params, Vec<u8> }) rather than reject:
        # no rotation ops exist, the keys are simply unused.
        read_params(r)
        r.byte_vec()
    rk = None
    if r.option():
        rk_params = read_params(r)
        ks = SealKSwitchKeysBlob.from_stream(r.byte_vec())
        if len(ks.keys) != 1:
            raise invalid_encoding("relin keys must hold exactly one vector")
        vec = ks.keys[0]
        k_ct = len(rk_params.ct_moduli)
        if len(vec) != k_ct:
            raise invalid_encoding("relin decomposition count mismatch")
        # Uniform (2, k_key, n) members, rejected at the boundary: the
        # engines index relin keys as a dense (k_ct, 2, k_key, n) block, so
        # a mis-shaped blob must never reach compute (a card kernel would
        # read out of bounds; golden would shape-error late).
        k_key = len(rk_params.key_moduli)
        for c in vec:
            if c.size != 2 or c.k != k_key or c.n != rk_params.n:
                raise invalid_encoding("relin key member has wrong shape")
        arr = np.stack([c.data for c in vec])         # (k_ct, 2, k_key, n)
        _check_parms_id(ks.parms_id, rk_params, rk_params.key_moduli,
                        "relin keys")
        _check_residue_range(arr, rk_params.key_moduli, "relin key")
        rk = RelinKeys(rk_params, np.ascontiguousarray(arr, dtype=np.uint64))
    r.expect_end()
    pk.relin = rk
    return pk


def save_public_key(pk: PublicKey) -> bytes:
    rk = pk.relin
    params = pk.params
    w = Writer()
    write_params(w, params)
    blob = SealCiphertextBlob(
        parms_id=compute_parms_id(params.n, params.key_moduli, params.t),
        is_ntt_form=True, n=params.n, k=len(params.key_moduli), data=pk.data)
    w.byte_vec(blob.to_stream())
    w.option(False)  # galois: never (fhe.rs:34-44)
    w.option(rk is not None)
    if rk is not None:
        write_params(w, rk.params)
        parms_id = compute_parms_id(rk.params.n, rk.params.key_moduli,
                                    rk.params.t)
        vec = [SealCiphertextBlob(parms_id=parms_id, is_ntt_form=True,
                                  n=rk.params.n,
                                  k=len(rk.params.key_moduli),
                                  data=rk.data[j])
               for j in range(rk.data.shape[0])]
        ks = SealKSwitchKeysBlob(parms_id, [vec])
        w.byte_vec(ks.to_stream())
    return w.getvalue()


# --------------------------------------------------------------------------
# PrivateKey
# --------------------------------------------------------------------------

def load_private_key(data: bytes) -> SecretKey:
    r = Reader(data)
    params = read_params(r)
    blob = SealPlaintextBlob.from_stream(r.byte_vec())
    r.expect_end()
    k_key, n = len(params.key_moduli), params.n
    if blob.data.size != k_key * n:
        raise invalid_encoding("secret key coefficient count mismatch")
    s_ntt = np.ascontiguousarray(blob.data.reshape(k_key, n),
                                 dtype=np.uint64)
    _check_parms_id(blob.parms_id, params, params.key_moduli, "secret key")
    _check_residue_range(s_ntt, params.key_moduli, "secret key")
    return SecretKey(params, s_ntt)


def save_private_key(sk: SecretKey) -> bytes:
    params = sk.params
    w = Writer()
    write_params(w, params)
    blob = SealPlaintextBlob(
        parms_id=compute_parms_id(params.n, params.key_moduli, params.t),
        data=sk.s_ntt.reshape(-1))
    w.byte_vec(blob.to_stream())
    return w.getvalue()


# --------------------------------------------------------------------------
# Ciphertext
# --------------------------------------------------------------------------

def load_ciphertext(data: bytes) -> Ciphertext:
    r = Reader(data)
    params = read_params(r)
    count = r.u64()
    if count != 1:
        raise invalid_encoding(f"multi-blob ciphertexts unsupported ({count})")
    blob = SealCiphertextBlob.from_stream(r.byte_vec())
    r.expect_end()
    if blob.n != params.n or blob.k != len(params.ct_moduli):
        raise invalid_encoding("ciphertext dimensions disagree with params")
    if blob.is_ntt_form:
        raise invalid_encoding("BFV ciphertexts must be in coefficient form")
    _check_parms_id(blob.parms_id, params, params.ct_moduli, "ciphertext")
    _check_residue_range(blob.data, params.ct_moduli, "ciphertext")
    return Ciphertext(params, np.ascontiguousarray(blob.data, dtype=np.uint64))


def save_ciphertext(ct: Ciphertext) -> bytes:
    params = ct.params
    w = Writer()
    write_params(w, params)
    w.u64(1)
    blob = SealCiphertextBlob(
        parms_id=compute_parms_id(params.n, params.ct_moduli, params.t),
        is_ntt_form=False, n=params.n, k=len(params.ct_moduli), data=ct.data)
    w.byte_vec(blob.to_stream())
    return w.getvalue()


# --------------------------------------------------------------------------
# Fast native key store (raw RNS arrays)
# --------------------------------------------------------------------------

def save_keys_native(path: str, pk: Optional[PublicKey] = None,
                     sk: Optional[SecretKey] = None) -> None:
    """Device-load-friendly key store: raw uint64 RNS arrays, no compression.

    Complements the reference-format (bincode+SEAL+zstd) codec above: this is
    what a serving fleet mmaps at startup.
    """
    params = (pk or sk).params
    arrays = {
        "n": np.array(params.n, dtype=np.uint64),
        "coeff_modulus": np.array(params.coeff_modulus, dtype=np.uint64),
        "plain_modulus": np.array(params.t, dtype=np.uint64),
    }
    if pk is not None:
        arrays["pk"] = pk.data
        if pk.relin is not None:
            arrays["relin"] = pk.relin.data
    if sk is not None:
        arrays["sk"] = sk.s_ntt
    np.savez(path, **arrays)


def load_keys_native(path: str
                     ) -> Tuple[Optional[PublicKey], Optional[SecretKey]]:
    with np.load(path) as z:
        params = Params(
            poly_modulus_degree=int(z["n"]),
            coeff_modulus=tuple(int(m) for m in z["coeff_modulus"]),
            plain_modulus=int(z["plain_modulus"]))
        pk = sk = None
        if "pk" in z:
            pk = PublicKey(params, z["pk"].astype(np.uint64))
            if "relin" in z:
                pk.relin = RelinKeys(params, z["relin"].astype(np.uint64))
        if "sk" in z:
            sk = SecretKey(params, z["sk"].astype(np.uint64))
    return pk, sk


# Attach convenience methods so pack.ObjectCodec can round-trip these types.
def _install_methods():
    Ciphertext.to_bytes = lambda self: save_ciphertext(self)
    Ciphertext.from_bytes = staticmethod(load_ciphertext)
    SecretKey.to_bytes = lambda self: save_private_key(self)
    SecretKey.from_bytes = staticmethod(load_private_key)
    PublicKey.to_bytes = lambda self: save_public_key(self)
    PublicKey.from_bytes = staticmethod(load_public_key)


_install_methods()

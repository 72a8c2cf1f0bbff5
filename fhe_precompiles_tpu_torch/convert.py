"""Carries state between the numpy layouts of the host model and the int64
tensors of the device path.

The host side (``bfv.golden`` here, and the JAX package's ``Ciphertext.data``,
``RelinKeys.data``, ``PublicKey.data``, ``SecretKey.s_ntt`` and plaintext
polynomials) holds residues as numpy ``uint64``.
The device path holds the same words as ``torch.int64`` (see
``ops/modmath.py``); residues are < 2**37, so the reinterpretation changes no
value.  Engine constants need no carrying: both sides derive them from the
same ``Params``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .params import Params


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64)).to(device)


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """uint64 array of any shape -> int64 tensor on `device` (same words):
    the inverse of ``to_numpy``, with no shape to hold it against."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint64:
        raise TypeError(f"expected uint64, got {arr.dtype}")
    return _to_tensor(arr, device)


def _check_residues(arr: np.ndarray, moduli: Sequence[int], what: str):
    """Every residue of limb row l (axis -2) must be below moduli[l]."""
    if arr.shape[-2] != len(moduli):
        raise ValueError(f"{what}: limb axis has {arr.shape[-2]} rows, "
                         f"expected {len(moduli)}")
    mods = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
    if (arr >= mods).any():
        raise ValueError(f"{what}: residue not below its modulus")


def ciphertexts_from_numpy(data, device, params: Optional[Params] = None,
                           check: bool = False) -> torch.Tensor:
    """uint64 (B, size, k, n), or a sequence of (size, k, n) arrays of one
    size, -> int64 tensor (B, size, k, n) on `device`.  With `params`, the
    shape is validated; with `check` too, every residue is held below its
    ciphertext modulus."""
    arr = np.asarray(data if isinstance(data, np.ndarray)
                     else np.stack([np.asarray(d) for d in data]))
    if arr.dtype != np.uint64:
        raise TypeError(f"ciphertexts: expected uint64, got {arr.dtype}")
    if arr.ndim != 4:
        raise ValueError("ciphertexts: expected (B, size, k, n), got shape "
                         f"{arr.shape}")
    if params is not None:
        k, n = len(params.ct_moduli), params.n
        if arr.shape[2:] != (k, n):
            raise ValueError(f"ciphertexts: expected (B, size, {k}, {n}), "
                             f"got {arr.shape}")
        if check:
            _check_residues(arr, params.ct_moduli, "ciphertexts")
    elif check:
        raise ValueError("ciphertexts: check=True needs params")
    return _to_tensor(arr, device)


def relin_keys_from_numpy(data: np.ndarray, device,
                          params: Optional[Params] = None,
                          check: bool = False) -> torch.Tensor:
    """uint64 (k, 2, k_key, n) NTT-form relin keys -> int64 tensor."""
    arr = np.asarray(data)
    if arr.dtype != np.uint64:
        raise TypeError(f"relin keys: expected uint64, got {arr.dtype}")
    if arr.ndim != 4 or arr.shape[1] != 2:
        raise ValueError("relin keys: expected (k, 2, k_key, n), got shape "
                         f"{arr.shape}")
    if params is not None:
        want = (len(params.ct_moduli), 2, len(params.key_moduli), params.n)
        if arr.shape != want:
            raise ValueError(f"relin keys: expected {want}, got {arr.shape}")
        if check:
            _check_residues(arr, params.key_moduli, "relin keys")
    elif check:
        raise ValueError("relin keys: check=True needs params")
    return _to_tensor(arr, device)


def public_key_from_numpy(data: np.ndarray, device,
                          params: Optional[Params] = None,
                          check: bool = False,
                          ct_limbs_only: bool = False) -> torch.Tensor:
    """uint64 (2, k_key, n) NTT-form public key -> int64 tensor.  With
    `ct_limbs_only` (needs `params`) the result is the ``[:, :k]`` slice over
    the ciphertext moduli, which is all that encryption reads."""
    arr = np.asarray(data)
    if arr.dtype != np.uint64:
        raise TypeError(f"public key: expected uint64, got {arr.dtype}")
    if arr.ndim != 3 or arr.shape[0] != 2:
        raise ValueError("public key: expected (2, k_key, n), got shape "
                         f"{arr.shape}")
    if params is not None:
        want = (2, len(params.key_moduli), params.n)
        if arr.shape != want:
            raise ValueError(f"public key: expected {want}, got {arr.shape}")
        if check:
            _check_residues(arr, params.key_moduli, "public key")
    elif check or ct_limbs_only:
        raise ValueError("public key: check / ct_limbs_only need params")
    if ct_limbs_only:
        arr = arr[:, :len(params.ct_moduli)]
    return _to_tensor(arr, device)


def secret_key_from_numpy(s_ntt: np.ndarray, device, params: Params,
                          check: bool = False) -> torch.Tensor:
    """uint64 (k_key, n) NTT-form secret key -> int64 tensor (k, n): the
    limbs over the ciphertext moduli, which is all that decryption reads."""
    arr = np.asarray(s_ntt)
    if arr.dtype != np.uint64:
        raise TypeError(f"secret key: expected uint64, got {arr.dtype}")
    want = (len(params.key_moduli), params.n)
    if arr.shape != want:
        raise ValueError(f"secret key: expected {want}, got {arr.shape}")
    if check:
        _check_residues(arr, params.key_moduli, "secret key")
    return _to_tensor(arr[:len(params.ct_moduli)], device)


def plaintexts_from_numpy(data, device, params: Optional[Params] = None,
                          check: bool = False) -> torch.Tensor:
    """uint64 (B, n) plaintext polynomials mod t -> int64 tensor (B, n)."""
    arr = np.asarray(data)
    if arr.dtype != np.uint64:
        raise TypeError(f"plaintexts: expected uint64, got {arr.dtype}")
    if arr.ndim != 2:
        raise ValueError(f"plaintexts: expected (B, n), got shape {arr.shape}")
    if params is not None:
        if arr.shape[1] != params.n:
            raise ValueError(f"plaintexts: expected (B, {params.n}), got "
                             f"{arr.shape}")
        if check and (arr >= np.uint64(params.t)).any():
            raise ValueError("plaintexts: coefficient not below the plain "
                             "modulus")
    elif check:
        raise ValueError("plaintexts: check=True needs params")
    return _to_tensor(arr, device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 residue tensor on any device -> numpy uint64 (same words)."""
    if x.dtype != torch.int64:
        raise TypeError(f"expected torch.int64, got {x.dtype}")
    return x.detach().cpu().contiguous().numpy().view(np.uint64)

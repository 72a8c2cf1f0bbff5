"""Deterministic zstd probe corpus + canonical-build self-check.

The port's own copy of ``fhe_precompiles_tpu/serialization/zstd_probes.py``,
with the canonical hashes in the port's ``data/zstd_canonical.json`` (a copy
of the JAX package's file).

Consensus bytes embed zstd level-3 frames, and zstd BUILDS diverge on some
payloads (system 1.5.4 vs the 1.5.7 wheel differ on sparse-centered-noise
ciphertext payloads -- attacker-steerable through any binary op output, so
a cross-stack consensus split; the reference pins per-platform golden
hashes for the same reason, fhe.rs:2103-2119).  The framework pins ONE
canonical build via this corpus: probe payloads are regenerated
deterministically (identically in the JAX package's C++,
native/precompiles.cpp build_canon_probe)
and their canonical frame hashes are checked in
(data/zstd_canonical.json, generated by tools/make_zstd_canonical.py).

Probe classes cover every wrap_stream payload class the codec can emit --
uniform residues at ciphertext (131 KB testnet / 393 KB n8192), public-key
(410 KB), secret-key (70 KB) and small-ring (16 KB) sizes; sparse centered
noise at both ciphertext sizes (the measured divergence window between
1.5.4 and 1.5.7); structured/zero/pattern payloads across zstd's
srcSize-based cparams breakpoints (<=16K, <=128K, <=256K, >256K).
"""
from __future__ import annotations

import hashlib
import json
import warnings
from typing import Dict, List

import numpy as np

from . import zstd_codec

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_TESTNET_P = 0xFFFFEE001  # first testnet modulus (sparse-noise value range)

#: The corpus spec.  Order and parameters are frozen: the JAX package's C++
#: side carries the same list in its generated zstd_canonical.h.
PROBES: List[Dict] = [
    {"id": "ct4096_uniform", "kind": "residue", "count": 2 * 2 * 4096,
     "seed": 0x9E3779B97F4A7C15},
    {"id": "ct8192_uniform", "kind": "residue", "count": 2 * 3 * 8192,
     "seed": 0x2545F4914F6CDD1D},
    {"id": "pk_uniform", "kind": "residue", "count": 51200,
     "seed": 0xDA942042E4DD58B5},
    {"id": "sk_uniform", "kind": "residue", "count": 8700,
     "seed": 0xC2B2AE3D27D4EB4F},
    {"id": "small_ring", "kind": "residue", "count": 2040,
     "seed": 0x9E3779B97F4A7C15},
    {"id": "ct4096_sparse_a", "kind": "sparse", "count": 2 * 2 * 4096,
     "seed": 0x1234567890ABCDEF},
    {"id": "ct4096_sparse_b", "kind": "sparse", "count": 2 * 2 * 4096,
     "seed": 0xDEADBEEFCAFEF00D},
    {"id": "ct8192_sparse", "kind": "sparse", "count": 2 * 3 * 8192,
     "seed": 0x9E3779B97F4A7C15},
    {"id": "struct257", "kind": "struct", "size": 257},
    {"id": "zeros4k", "kind": "zeros", "size": 4096},
    {"id": "pattern200k", "kind": "pattern", "size": 200 * 1024},
    {"id": "pattern300k", "kind": "pattern", "size": 300 * 1024},
]


def _xorshift(seed: int, count: int) -> np.ndarray:
    x = np.uint64(seed)
    out = np.empty(count, dtype=np.uint64)
    s13, s7, s17 = np.uint64(13), np.uint64(7), np.uint64(17)
    for i in range(count):
        x = (x ^ (x << s13)) & _M64
        x ^= x >> s7
        x = (x ^ (x << s17)) & _M64
        out[i] = x
    return out


def build_probe(p: Dict) -> bytes:
    kind = p["kind"]
    if kind == "residue":
        v = _xorshift(p["seed"], p["count"]) & np.uint64((1 << 37) - 1)
        return b"\x00" * 73 + v.tobytes()
    if kind == "sparse":
        x = _xorshift(p["seed"], p["count"])
        sel = x & np.uint64(3)
        v = np.zeros(p["count"], dtype=np.uint64)
        small = (x >> np.uint64(2)) % np.uint64(40)
        v[sel == 0] = small[sel == 0]
        near_p = (np.uint64(_TESTNET_P - 1)
                  - ((x >> np.uint64(2)) % np.uint64(39)))
        v[sel == 1] = near_p[sel == 1]
        return b"\x00" * 73 + v.tobytes()
    if kind == "struct":
        return bytes((i * 7) & 0xFF for i in range(p["size"]))
    if kind == "zeros":
        return bytes(p["size"])
    if kind == "pattern":
        return bytes(((i % 37) * 11 + i // 8192) & 0xFF
                     for i in range(p["size"]))
    raise ValueError(f"unknown probe kind {kind!r}")


def load_canonical() -> Dict:
    import importlib.resources
    ref = (importlib.resources.files("fhe_precompiles_tpu_torch") / "data"
           / "zstd_canonical.json")
    return json.loads(ref.read_text())


_checked: "list[bool]" = []


def check_python_zstd_canonical(warn: bool = True) -> bool:
    """One-time self-check: does this process's zstd codec (``zstd_codec``:
    the `zstandard` module, or libzstd through ctypes where it does not
    import) produce the canonical frames?  Returns the cached verdict on
    repeat calls.

    A non-canonical build means every ciphertext this process emits may
    differ from the fleet's canonical bytes on low-entropy payloads -- a
    consensus risk surfaced as a RuntimeWarning, not an error (operators
    running an intentionally different fleet-wide build can ignore it).
    """
    if _checked:
        return _checked[0]
    doc = load_canonical()
    comp = zstd_codec.compressor(doc["level"])
    ok = True
    bad = None
    for p, e in zip(PROBES, doc["probes"]):
        assert p["id"] == e["id"], "probe spec drifted from fixtures"
        frame = comp.compress(build_probe(p))
        if hashlib.sha512(frame).hexdigest() != e["sha512"]:
            ok = False
            bad = p["id"]
            break
    if not ok and warn:
        warnings.warn(
            f"this process's zstd codec ({zstd_codec.codec_name()}) is NOT "
            f"the consensus-canonical build ({doc['canonical_build']}): "
            f"frame mismatch on probe {bad!r}.  Emitted ciphertext bytes may "
            "split from canonical validators on low-entropy payloads.",
            RuntimeWarning)
    _checked.append(ok)
    return ok

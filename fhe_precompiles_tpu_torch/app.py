"""FheApp: the byte-in/byte-out precompile surface (49 operations).

The port's own copy of ``fhe_precompiles_tpu/app.py``.  Parity target: the
reference's ``src/fhe.rs:56-780``.

* 36 binary ops: {add,sub,mul} x {u256,u64,i64,frac64} x {cipher-cipher,
  cipher-plain, plain-cipher} (fhe.rs:161-576, programs at fhe.rs:782-1022).
* Threshold-network simulation API: encrypt / reencrypt / decrypt x 4 types +
  public_key_bytes (fhe.rs:578-779).
* Error codes on failure follow lib.rs:14-27 via FheError.

The compute engine is the golden host model (default, canonical bytes), the
port's ``TorchEngine`` on the device the caller names (the card by default)
or the C++ host engine on the CPU (``native/engine.py``) -- all three
produce identical ciphertext bytes, so validators on different hardware
stay in consensus.
"""
from __future__ import annotations

import hashlib
import importlib.resources
from typing import Callable, Optional, Tuple

from . import pack
from .bfv.golden import BfvContext, Ciphertext, PublicKey
from .encoding import (FRAC64_TYPE, I64_TYPE, U64_TYPE, U256_TYPE,
                       PlainType)
from .errors import (FheError, FheErrorCode, failed_decryption,
                     failed_encryption)
from .ops.engine import TorchEngine
from .params import Params
from .serialization import keyio

#: The reference's fixed 512-bit private constant mixed into every
#: threshold-encrypt seed derivation (fhe.rs:604-609).  Part of the protocol:
#: identical bytes are required for consensus-compatible seed derivation.
ENCRYPT_PRIVATE_CONSTANT = bytes([
    15, 17, 225, 5, 30, 1, 237, 218, 130, 19, 37, 95, 222, 218, 244, 172,
    214, 175, 175, 110, 173, 103, 172, 60, 43, 76, 40, 150, 215, 96, 23, 78,
    22, 39, 30, 177, 107, 130, 124, 109, 27, 96, 206, 125, 104, 241, 10, 40,
    88, 238, 117, 118, 79, 113, 213, 110, 148, 179, 53, 19, 227, 154, 151, 122,
])

_CT_CODEC = pack.ObjectCodec(Ciphertext)


class _CachedPkCodec(pack.ObjectCodec):
    """Digest-keyed LRU over public-key parsing.

    Calldata carries the full pk + relin keys (~400 KB of zstd) on every
    binary op; serving streams reuse a handful of keys, so caching the
    parsed (immutable) PublicKey removes ~1.5 ms/call of decompression.
    Keyed by the exact input bytes -- semantics are unchanged.
    """

    _MAX = 16

    def __init__(self):
        super().__init__(PublicKey)
        self._cache: "dict[bytes, PublicKey]" = {}
        self._order: "list[bytes]" = []

    def deserialize(self, data: bytes) -> PublicKey:
        return self.deserialize_keyed(data)[1]

    def deserialize_keyed(self, data: bytes) -> Tuple[bytes, PublicKey]:
        """(the SHA-256 of `data`, its key): ``ByteServer`` groups requests
        by the digest, which is equal for equal bytes also where an
        eviction gave them a second object."""
        key = hashlib.sha256(data).digest()
        hit = self._cache.get(key)
        if hit is not None:
            return key, hit
        obj = super().deserialize(data)
        # threads that parse the same key at once all get the first parse
        hit = self._cache.setdefault(key, obj)
        if hit is not obj:
            return key, hit
        self._order.append(key)
        if len(self._order) > self._MAX:
            evict = self._order.pop(0)
            self._cache.pop(evict, None)
        return key, obj


_PK_CODEC = _CachedPkCodec()

_SCALAR_CODECS = {
    "u256": pack.U256, "u64": pack.U64, "i64": pack.I64, "frac64": pack.FRAC64,
}
_TYPE_BY_NAME = {
    "u256": U256_TYPE, "u64": U64_TYPE, "i64": I64_TYPE, "frac64": FRAC64_TYPE,
}


def _load_embedded(name: str) -> bytes:
    ref = (importlib.resources.files("fhe_precompiles_tpu_torch") / "data"
           / name)
    return ref.read_bytes()


class FheApp:
    """Precompile runtime bound to one parameter set + the network keypair.

    Mirrors ``FheApp`` (fhe.rs:56-131).  `engine` selects the compute
    backend: "golden" (canonical numpy reference), "torch" (``TorchEngine``
    on `device`, the card unless the caller names another; without a card
    it raises, as ``TorchEngine`` does) or "native" (``NativeEngine``, the
    C++ host engine on the CPU: the CPU validator's engine, chosen by name,
    never in place of a missing card) -- all three emit byte-identical
    ciphertexts (tests/test_torch_app.py,
    tests/test_torch_native_byte_path.py).  `device` is used by "torch"
    only.
    """

    def __init__(self, params: Params,
                 network_public_key_bytes: Optional[bytes] = None,
                 network_private_key_bytes: Optional[bytes] = None,
                 engine: str = "golden", device="cuda"):
        self.params = params
        self.ctx = BfvContext(params)
        if network_public_key_bytes is None:
            network_public_key_bytes = _load_embedded("network.pub")
        if network_private_key_bytes is None:
            network_private_key_bytes = _load_embedded("network.pri")
        self._public_key_bytes = network_public_key_bytes
        self.public_key = keyio.load_public_key(network_public_key_bytes)
        self.private_key = keyio.load_private_key(network_private_key_bytes)
        if (self.public_key.params != params
                or self.private_key.params != params):
            raise FheError(FheErrorCode.INVALID_ENCODING,
                           "network key parameter set mismatch")
        if engine == "golden":
            self._engine = self.ctx
        elif engine == "torch":
            self._engine = TorchEngine(params, device=device, golden=self.ctx)
        elif engine == "native":
            from .native.engine import NativeEngine
            self._engine = NativeEngine(params, golden=self.ctx)
        else:
            raise ValueError(f"unknown engine {engine!r} "
                             "(expected 'golden', 'torch' or 'native')")

    # ------------------------------------------------------------------
    # key generation (fhe.rs:133-136; galois keys stripped per fhe.rs:34-44)
    # ------------------------------------------------------------------
    def generate_keys(self):
        # an engine with keygen (native C++) makes the golden model's keys
        # bit for bit (test_torch_native_engine.py); TorchEngine has none
        eng = self._engine
        return (eng if hasattr(eng, "generate_keys") else self.ctx
                ).generate_keys()

    # ------------------------------------------------------------------
    # core arithmetic dispatch
    # ------------------------------------------------------------------
    def _run_op(self, op: str, shape: str, ptype: PlainType,
                a, b, public_key: PublicKey) -> Ciphertext:
        eng = self._engine
        try:
            if shape == "cc":
                if op == "add":
                    return eng.add(a, b)
                if op == "sub":
                    return eng.sub(a, b)
                if public_key.relin is None:
                    raise FheError(FheErrorCode.RUNTIME_ERROR,
                                   "public key lacks relinearization keys")
                # A relin key whose params differ from the app's would be
                # range-checked against ITS OWN moduli only (keyio), so its
                # residues can exceed the app moduli — non-canonical inputs
                # on which the card kernels' Shoup/lazy bounds no longer
                # hold (bytes could diverge from golden with code 0).
                # Reject like the reference's native stack does
                # (precompiles.cpp do_binary rk_params guard) ->
                # RUNTIME_ERROR.
                if public_key.relin.params != self.params:
                    raise FheError(FheErrorCode.RUNTIME_ERROR,
                                   "relin key parameter set mismatch")
                return eng.mul_relin(a, b, public_key.relin)
            if shape == "cp":
                pb = ptype.encode(b, self.params)
                if op == "add":
                    return eng.add_plain(a, pb)
                if op == "sub":
                    return eng.sub_plain(a, pb)
                return eng.mul_plain(a, pb)
            # pc: plain op cipher
            pa = ptype.encode(a, self.params)
            if op == "add":
                return eng.add_plain(b, pa)
            if op == "sub":
                return eng.plain_sub(pa, b)
            return eng.mul_plain(b, pa)
        except FheError:
            raise
        except Exception as exc:
            raise FheError(FheErrorCode.RUNTIME_ERROR, str(exc)) from exc

    def _check_params(self, obj, code: FheErrorCode) -> None:
        """Reject objects whose embedded Params differ from the app's.

        The reference hits SEAL's parms_id check inside the runtime, so a
        mismatch surfaces as the stage's runtime failure code (run -> 7,
        decrypt -> 5, encrypt -> 6), never as silent wrong-modulus compute.
        Without this, a blob carrying forged moduli would be range-checked
        against its *own* moduli only and could split consensus.
        """
        if obj is not None and obj.params != self.params:
            raise FheError(code, "parameter set mismatch")

    def _binary_op(self, op: str, shape: str, tname: str,
                   input_bytes: bytes) -> bytes:
        """The fhe_binary_op path (fhe.rs:21-31)."""
        scalar = _SCALAR_CODECS[tname]
        ptype = _TYPE_BY_NAME[tname]
        ca = _CT_CODEC if shape in ("cc", "cp") else scalar
        cb = _CT_CODEC if shape in ("cc", "pc") else scalar
        public_key, a, b = pack.unpack_binary_operation(
            input_bytes, _PK_CODEC, ca, cb)
        self._check_params(public_key, FheErrorCode.RUNTIME_ERROR)
        if shape in ("cc", "cp"):
            self._check_params(a, FheErrorCode.RUNTIME_ERROR)
        if shape in ("cc", "pc"):
            self._check_params(b, FheErrorCode.RUNTIME_ERROR)
        result = self._run_op(op, shape, ptype, a, b, public_key)
        return result.to_bytes()

    # ------------------------------------------------------------------
    # threshold network simulation API (fhe.rs:578-779)
    # ------------------------------------------------------------------
    def _encrypt(self, tname: str, input_bytes: bytes) -> bytes:
        """Deterministic encrypt under the network key (fhe.rs:594-618)."""
        scalar = _SCALAR_CODECS[tname]
        ptype = _TYPE_BY_NAME[tname]
        plain, public_data = pack.unpack_two_arguments(
            input_bytes, scalar, pack.BYTES)
        h = hashlib.sha512()
        h.update(public_data)
        h.update(ENCRYPT_PRIVATE_CONSTANT)
        h.update(scalar.serialize(plain))
        seed = h.digest()
        eng = self._engine
        try:
            ct = eng.encrypt(ptype.encode(plain, self.params),
                             self.public_key, seed)
        except Exception as exc:
            # reference maps every encrypt-side failure (incl. encoding
            # overflow) to FailedEncryption, fhe.rs:616
            raise failed_encryption(str(exc)) from exc
        return ct.to_bytes()

    def _reencrypt(self, tname: str, input_bytes: bytes) -> bytes:
        """Decrypt under the network key, deterministically re-encrypt under a
        caller key (fhe.rs:632-678); seed binds the full input."""
        scalar = _SCALAR_CODECS[tname]
        ptype = _TYPE_BY_NAME[tname]
        public_key, ciphertext, public_data = pack.unpack_binary_operation(
            input_bytes, _PK_CODEC, _CT_CODEC, pack.BYTES)
        self._check_params(ciphertext, FheErrorCode.FAILED_DECRYPTION)
        self._check_params(public_key, FheErrorCode.FAILED_ENCRYPTION)
        public_data = public_data + input_bytes  # fhe.rs:676
        eng = self._engine
        try:
            poly = eng.decrypt(ciphertext, self.private_key)
            value = ptype.decode(poly, self.params)
        except Exception as exc:
            # reference maps every decrypt-side failure (incl. decode
            # overflow) to FailedDecryption, fhe.rs:644
            raise failed_decryption(str(exc)) from exc
        h = hashlib.sha512()
        h.update(public_data)
        h.update(scalar.serialize(value))
        seed = h.digest()
        try:
            ct = eng.encrypt(ptype.encode(value, self.params),
                             public_key, seed)
        except Exception as exc:
            raise failed_encryption(str(exc)) from exc
        return ct.to_bytes()

    def _decrypt(self, tname: str, input_bytes: bytes) -> bytes:
        """Decrypt under the network key; output is the scalar's BE bytes,
        NOT bincode (fhe.rs:688-699)."""
        scalar = _SCALAR_CODECS[tname]
        ptype = _TYPE_BY_NAME[tname]
        ciphertext = pack.unpack_one_argument(input_bytes, _CT_CODEC)
        self._check_params(ciphertext, FheErrorCode.FAILED_DECRYPTION)
        eng = self._engine
        try:
            poly = eng.decrypt(ciphertext, self.private_key)
            value = ptype.decode(poly, self.params)
        except Exception as exc:
            # reference: all decrypt failures -> FailedDecryption (fhe.rs:696)
            raise failed_decryption(str(exc)) from exc
        return scalar.serialize(value)

    def public_key_bytes(self, _input: bytes = b"") -> bytes:
        """fhe.rs:701-703: the stored network public key bytes, verbatim."""
        return self._public_key_bytes

    # ------------------------------------------------------------------
    # observability (no reference analog)
    # ------------------------------------------------------------------
    def noise_budget(self, ciphertext_bytes: bytes) -> float:
        """Remaining noise budget (bits) of a network-key ciphertext.

        Diagnostic API: log2(q / (2*|noise|)); 0 means decryption is about
        to fail.  Requires the network private key (server-side only).
        """
        ct = Ciphertext.from_bytes(ciphertext_bytes)
        self._check_params(ct, FheErrorCode.FAILED_DECRYPTION)
        return self.ctx.noise_budget_bits(ct, self.private_key)

    # ------------------------------------------------------------------
    # C-ABI style entry: name + bytes -> (code, payload)
    # ------------------------------------------------------------------
    def call(self, name: str, input_bytes: bytes):
        """Run a precompile by name, returning (error_code, payload_bytes).

        Code 0 = success (the c_fhe.rs:22-56 contract).  Per-op metrics are
        recorded when metrics.enable() has been called.
        """
        from . import metrics
        if name not in PRECOMPILE_NAMES:
            return int(FheErrorCode.INVALID_ENCODING), b""
        fn = getattr(self, name)
        try:
            with metrics.GLOBAL.measure(name, len(input_bytes)):
                out = fn(input_bytes)
            metrics.GLOBAL.record_output(name, len(out))
            return 0, out
        except FheError as e:
            return int(e.code), b""
        except Exception:
            return int(FheErrorCode.RUNTIME_ERROR), b""


# --------------------------------------------------------------------------
# Generate the 49 named precompile methods (macro analog of fhe.rs:161-779)
# --------------------------------------------------------------------------

def _make_binary(op: str, shape: str, tname: str) -> Callable:
    def method(self: FheApp, input_bytes: bytes) -> bytes:
        return self._binary_op(op, shape, tname, input_bytes)
    return method


def _install_ops():
    for tname in ("u256", "u64", "i64", "frac64"):
        c, p = f"cipher{tname}", tname
        for op in ("add", "sub", "mul"):
            specs = {
                f"{op}_{c}_{c}": ("cc",),
                f"{op}_{c}_{p}": ("cp",),
                f"{op}_{p}_{c}": ("pc",),
            }
            for name, (shape,) in specs.items():
                m = _make_binary(op, shape, tname)
                m.__name__ = name
                m.__doc__ = (f"Precompile {name}: expects "
                             f"pack_binary_operation input (fhe.rs parity).")
                setattr(FheApp, name, m)
        setattr(FheApp, f"encrypt_{tname}",
                (lambda tn: lambda self, b: self._encrypt(tn, b))(tname))
        setattr(FheApp, f"reencrypt_{tname}",
                (lambda tn: lambda self, b: self._reencrypt(tn, b))(tname))
        setattr(FheApp, f"decrypt_{tname}",
                (lambda tn: lambda self, b: self._decrypt(tn, b))(tname))


_install_ops()

#: All 49 precompile entry points, in the reference's declaration order
#: (c_fhe.rs:74-141) -- the C ABI shim iterates this list.
PRECOMPILE_NAMES = tuple(
    f"{op}_{a}_{b}"
    for t in ("u256", "u64", "i64", "frac64")
    for op in ("add", "sub", "mul")
    for a, b in ((f"cipher{t}", f"cipher{t}"), (f"cipher{t}", t),
                 (t, f"cipher{t}"))
) + tuple(
    f"{kind}_{t}"
    for kind in ("encrypt", "reencrypt", "decrypt")
    for t in ("u256", "u64", "i64", "frac64")
) + ("public_key_bytes",)

assert len(PRECOMPILE_NAMES) == 49

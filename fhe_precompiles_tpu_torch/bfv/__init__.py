"""BFV scheme core of the port: host golden model, NTT tables, modular math.

``golden.py`` is the canonical bit-exact semantics; the device path in
``fhe_precompiles_tpu_torch.ops`` must match it byte-for-byte.
"""
from .golden import (BfvContext, Ciphertext, PublicKey, RelinKeys,  # noqa: F401
                     SecretKey)

"""Wire formats: bincode framing + SEAL 4.x blob codec + key/ciphertext IO.

The port's own copy of ``fhe_precompiles_tpu/serialization/``.  Parity
target: the reference's embedded key blobs (``src/data/network.{pub,pri}``)
and test fixtures (``tests/data/*.bin``), which are bincode-framed sunscreen
types wrapping zstd-compressed SEAL 4.x serialized objects.
"""
from . import bincode, seal  # noqa: F401

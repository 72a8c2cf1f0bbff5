"""PyTorch / CUDA port of the BFV precompiles: the 49 byte-level operations of
``FheApp`` over batched encrypt, decrypt, elementwise operations and
ciphertext multiply + relinearization on an NVIDIA GPU.

A second package beside ``fhe_precompiles_tpu`` (the JAX reference).  It
imports ``torch``, ``numpy`` and ``zstandard`` only and keeps its own copies
of the host modules it needs (``params``, ``sampling``, ``bfv``, ``errors``,
``pack``, ``encoding``, ``serialization``, ``metrics``, ``app``, ``testnet``).
The device path is ``ops.engine.TorchEngine``; the five BEHZ tail kernels
and the forward and inverse NTT kernels are CUDA C++ under ``csrc/`` and are
built at first use, never on import.

Public API (as the JAX package's):
  * FheApp           -- the 49-operation byte-level precompile runtime
  * pack             -- calldata framing + per-type codecs
  * testnet.one      -- first-testnet params / runtime / app singletons
  * FheError & codes -- stable error model
"""
from .app import FheApp, PRECOMPILE_NAMES  # noqa: F401
from .errors import FheError, FheErrorCode, error_code_to_str  # noqa: F401
from .params import Params, PRESETS, get_params  # noqa: F401
from . import pack  # noqa: F401
from . import testnet  # noqa: F401

__version__ = "0.1.0"

"""PyTorch / CUDA port of the BFV engine: batched encrypt, decrypt, elementwise
operations and ciphertext multiply + relinearization on an NVIDIA GPU.

A second package beside ``fhe_precompiles_tpu`` (the JAX reference).  It
imports ``torch`` and ``numpy`` only and keeps its own copies of the host
modules it needs (``params``, ``sampling``, ``bfv``).  The device path is
``ops.engine.TorchEngine``; the five BEHZ tail kernels and the forward and
inverse NTT kernels are CUDA C++ under ``csrc/`` and are built at first use.
"""
__version__ = "0.1.0"

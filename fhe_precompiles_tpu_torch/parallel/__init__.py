"""Serving many requests at once.

The port's counterpart of ``fhe_precompiles_tpu/parallel/``, on one card so
far: ``stream.RequestStream`` groups a mixed stream of cipher∘cipher
requests by op kind and runs each group as batches through ``TorchEngine``.
The JAX package's mesh, limb sharding, distributed NTT and pipeline are not
ported yet.
"""
from .stream import Request, RequestStream, bucket_batch  # noqa: F401

"""Serving many requests at once, on one device or over several.

The port's counterpart of ``fhe_precompiles_tpu/parallel/``, on
``torch.distributed`` with one process a device (NCCL between cards, gloo
on the CPU):

* ``multihost``: ``initialize`` (rendezvous from its arguments only),
  ``global_mesh``, ``is_primary``;
* ``mesh``: ``Mesh`` (named axes over ranks, one process group an axis
  line), ``make_mesh`` (the (dp, tp) mesh), ``shard_ct_batch`` /
  ``gather_ct_batch``, the collectives along an axis, and ``checked``
  (a local step's failure on any rank raises ``RankFault`` on every rank);
* ``stream``: ``RequestStream`` groups a mixed stream of cipher∘cipher
  requests by op kind and runs each group as batches through
  ``TorchEngine``, over a mesh with the batch on dp and, with
  ``shard_limbs``, the limbs on tp;
* ``dist_ntt``: the negacyclic NTT with its coefficient axis sharded over
  a mesh axis;
* ``pipeline``: ``pipeline_chain``, a GPipe schedule over a ``pp`` axis.
"""
from .mesh import make_mesh, shard_ct_batch  # noqa: F401
from .stream import Request, RequestStream, bucket_batch  # noqa: F401

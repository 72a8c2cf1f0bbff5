"""Pipeline parallelism for chains of one homomorphic op over a ``pp`` axis.

The port's counterpart of ``fhe_precompiles_tpu/parallel/pipeline.py``: a
synchronous GPipe schedule.  Each of the P ranks of the ``pp`` axis is one
stage; microbatch m passes through the P stages in order, so the result is
P applications of the op to every microbatch.  FHE ops carry no per-stage
weights (the relin key is one replicated tensor), so the schedule buys no
weight residency; what it costs is the bubble (M / (M + P - 1) of the
steps do work for M microbatches) and one hand-off a step.

The schedule takes M + P - 1 steps.  At step t, rank 0 takes microbatch t
(while t < M), every rank holding an item applies the op, hands its result
to rank r + 1, and the last rank banks item t - (P - 1).  The JAX version
runs the op on every device every step and shifts the whole ring; its
wrap edge (P - 1 -> 0) and the idle steps carry only values nobody reads,
so here a rank without an item computes and sends nothing.  At the end the
last rank broadcasts the (M, ...) result, so every rank returns it.
"""
from __future__ import annotations

from typing import Callable

import torch

from .mesh import Mesh, broadcast_axis, exchange, replicate


def pipeline_chain(op: Callable, mesh: Mesh, microbatches: torch.Tensor,
                   *op_args) -> torch.Tensor:
    """Run every microbatch through P sequential applications of `op`.

    op(x, *op_args) -> x' is one stage (the same op each stage: FHE chains
    are homogeneous) and keeps x's shape and dtype.  `microbatches` has
    shape (M, ...) and is the same on every rank; the result, on every
    rank, is (M, ...) on the mesh's device, element m having passed
    through P stages."""
    P = mesh.axis_size("pp")
    r = mesh.axis_index("pp")
    M = microbatches.shape[0]
    mbs = replicate(microbatches, mesh)
    out = torch.zeros_like(mbs)
    held = None                     # the item this rank works on this step
    for t in range(M + P - 1):
        if r == 0 and t < M:
            held = mbs[t]
        res = None
        if held is not None:
            res = op(held, *op_args)
            if r == P - 1:
                out[t - (P - 1)] = res
        # rank r holds item t - r at step t; it hands the item on to rank
        # r + 1, which holds it at step t + 1
        send = r + 1 if res is not None and r < P - 1 else None
        item = t + 1 - r            # the item this rank holds next step
        recv = r - 1 if r > 0 and 0 <= item < M else None
        if P > 1:
            held = exchange(res, mesh, "pp", send, recv, like=mbs[0])
        else:
            held = None
    return broadcast_axis(out, mesh, "pp", P - 1) if P > 1 else out

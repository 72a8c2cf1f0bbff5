"""Multi-process bring-up: ``torch.distributed`` rendezvous and the global
mesh.

The port's counterpart of ``fhe_precompiles_tpu/parallel/multihost.py``.
PyTorch runs one process a device; the processes meet through
``torch.distributed``: NCCL between cards, gloo on the CPU.  Where the JAX
version reads ``JAX_COORDINATOR_ADDRESS`` and its siblings when called
without arguments, the port takes the rendezvous from its arguments only:
the coordinator's ``host:port``, the number of processes and this
process's rank.  It reads no environment (no ``MASTER_ADDR``, no ``RANK``,
no ``init_method="env://"``), and it never picks a process's device from
its rank: the caller names it.

The service holds no state but its keys and parameters, so recovery is
calling ``initialize`` again and reloading the keys, as in the JAX version.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, world_size

BACKENDS = ("nccl", "gloo")


def resolve_backend(device, backend: Optional[str] = None) -> str:
    """The backend for a process whose device is `device`: the one named,
    else NCCL for a card and gloo for the CPU.  NCCL on a CPU device is
    refused; gloo on a card is allowed (its collectives then pass through
    host memory)."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
    return backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None) -> None:
    """Join (or bootstrap) a run of `num_processes` processes.

    With no coordinator and `num_processes` None or 1 this is a no-op: the
    world is this process alone.  Otherwise every process calls
    ``dist.init_process_group(backend, init_method=
    f"tcp://{coordinator_address}", world_size=num_processes,
    rank=process_id)``; process 0 listens on the address.  `device` is
    this process's device (for example ``f"cuda:{local_index}"``); it
    chooses the default backend (``resolve_backend``) and is where NCCL
    binds.  Calling it again once the group exists does nothing.  A
    backend that fails to start raises; there is no other to switch to.
    """
    backend = resolve_backend(device, backend)
    if coordinator_address is None and num_processes in (None, 1):
        return      # one process: nothing to join
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: a run of several processes needs "
                         "coordinator_address, num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of "
                         f"{num_processes}")
    kwargs = {}
    if backend == "nccl":
        dev = torch.device(device)
        kwargs["device_id"] = dev if dev.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def global_mesh(dp: Optional[int] = None, tp: int = 1, *,
                device="cuda") -> Mesh:
    """A (dp, tp) mesh over every process of the run, ranks in order.
    Every process must call it (``Mesh`` creates one group an axis line).
    Raises ValueError where dp * tp is not the world's size."""
    world = world_size()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"{world} global devices != dp*tp = {dp}*{tp}")
    return make_mesh(dp, tp, device=device)


def is_primary() -> bool:
    """Whether this is process 0 (true where no process group exists)."""
    return not dist.is_initialized() or dist.get_rank() == 0

"""A mesh of named axes over the ranks of a ``torch.distributed`` world,
the shards of a ciphertext batch on it, and the collectives between them.

The port's counterpart of ``fhe_precompiles_tpu/parallel/mesh.py``.  Mesh
axes keep the JAX version's meaning:
  dp  -- the batch axis of the request stream (data parallel)
  tp  -- the RNS limb axis (tensor parallel)
and ``dist_ntt`` adds ``sp`` (the coefficient axis), ``pipeline`` ``pp``.

The process model differs.  JAX has one controller that drives every
device and inserts the collectives; PyTorch has one process a device.  So
a ``Mesh`` here is what one rank knows: the grid of ranks, this rank's
place in it, its device, and one process group for each axis line through
it.  Each rank holds its shard as a plain local tensor on its own device,
and every collective is an explicit call.  Every rank calls the same
functions with the same inputs (SPMD) and gets the same full result, as a
JAX global array would give it.

Where no process group exists the world is this process alone: a mesh of
one rank, whose collectives are the identity.  A world of one that has a
group still runs them through it (so an NCCL world of one runs NCCL).
Under gloo a CUDA tensor goes through host memory, copied out and back
once, explicitly; the choice is made by the group's backend.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import convert


def world_size() -> int:
    """The processes of the run: 1 where no process group exists."""
    return dist.get_world_size() if dist.is_initialized() else 1


def same_device(a, b) -> bool:
    """Whether two device names are one device ("cuda" is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if (a.index is None
                                          or b.index is None) else None
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)


class Mesh:
    """Named axes over ranks.  ``shape`` maps each axis to its size, in
    order (``{"dp": 4, "tp": 2}``, as a JAX mesh's); ``ranks`` is the grid
    of global ranks (the world's first ranks in order by default);
    ``device`` is this rank's device.

    Every rank of the world must build every mesh, in the same order:
    ``dist.new_group`` is a collective of the whole world, and the
    constructor calls it once for each line of each axis."""

    def __init__(self, shape: Dict[str, int],
                 ranks: Optional[Sequence[int]] = None, device="cuda"):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        sizes = tuple(self.shape.values())
        if not sizes or min(sizes) < 1:
            raise ValueError(f"mesh axes must have sizes >= 1, got {shape}")
        need = math.prod(sizes)
        has_group = dist.is_initialized()
        world = world_size()
        ranks = list(range(need)) if ranks is None else [int(r)
                                                         for r in ranks]
        if len(ranks) != need:
            raise ValueError(f"mesh {self.shape} needs {need} ranks, got "
                             f"{len(ranks)}")
        if len(set(ranks)) != need or not all(0 <= r < world for r in ranks):
            raise ValueError(f"mesh ranks {ranks} are not distinct ranks of "
                             f"a world of {world}")
        self.device = torch.device(device)
        if has_group and dist.get_backend() == "nccl" \
                and self.device.type != "cuda":
            raise ValueError(f"an NCCL world needs CUDA devices, got "
                             f"{self.device}")
        self.ranks = np.array(ranks, dtype=np.int64).reshape(sizes)
        self.rank = dist.get_rank() if has_group else 0
        where = np.argwhere(self.ranks == self.rank)
        self._coords = tuple(int(c) for c in where[0]) if len(where) else None
        #: axis -> (process group, global ranks of the line through this
        #: rank); empty where no process group exists
        self._groups: Dict[str, tuple] = {}
        if has_group:
            for ax, name in enumerate(self.shape):
                lines = np.moveaxis(self.ranks, ax, -1).reshape(-1, sizes[ax])
                for line in lines.tolist():     # the same order on every rank
                    group = dist.new_group(ranks=line)
                    if self.rank in line:
                        self._groups[name] = (group, line)

    def _axis(self, name: str) -> int:
        if name not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        if self._coords is None:
            raise ValueError(f"rank {self.rank} is not in mesh {self.shape}")
        return list(self.shape).index(name)

    def axis_index(self, name: str) -> int:
        """This rank's index along axis `name`."""
        return self._coords[self._axis(name)]

    def axis_size(self, name: str) -> int:
        if name not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        return self.shape[name]

    def group(self, name: str):
        """(process group, global ranks) of the line of axis `name` through
        this rank; None where no process group exists."""
        self._axis(name)
        return self._groups.get(name)


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              ranks: Optional[Sequence[int]] = None, *,
              device="cuda") -> Mesh:
    """Build a (dp, tp) mesh over the world's ranks (or `ranks`).

    With dp=None, uses all remaining ranks on the data axis.  Every rank
    of the world calls it."""
    ranks = list(range(world_size()) if ranks is None else ranks)
    if dp is None:
        if len(ranks) % tp:
            raise ValueError(f"{len(ranks)} devices not divisible by "
                             f"tp={tp}")
        dp = len(ranks) // tp
    need = dp * tp
    if need > len(ranks):
        raise ValueError(f"need {need} devices, have {len(ranks)}")
    return Mesh({"dp": dp, "tp": tp}, ranks[:need], device=device)


# ----------------------------------------------------------------------
# collectives along one axis
# ----------------------------------------------------------------------
def _via_host(group, x: torch.Tensor) -> bool:
    """Whether `x` crosses `group` through host memory: a CUDA tensor in a
    gloo group.  gloo's transports read host memory: its send of a CUDA
    tensor aborts the process (``PERF.md`` §6, measured on an H100)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_axis(x: torch.Tensor, mesh: Mesh, axis: str,
                    dim: int) -> torch.Tensor:
    """Every rank's `x` along axis `axis`, concatenated on `dim` in the
    axis's order.  Every rank of the line passes a tensor of one shape."""
    line = mesh.group(axis)
    if line is None:
        return x
    group, ranks = line
    host = _via_host(group, x)
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


def broadcast_axis(x: torch.Tensor, mesh: Mesh, axis: str,
                   src: int) -> torch.Tensor:
    """Rank `src`'s `x` (an index along `axis`) on every rank of the line;
    the others pass a tensor of its shape and dtype."""
    line = mesh.group(axis)
    if line is None:
        return x
    group, ranks = line
    host = _via_host(group, x)
    buf = (x.cpu() if host else x).contiguous()
    dist.broadcast(buf, src=ranks[src], group=group)
    return buf.to(x.device) if host else buf


def exchange(x: Optional[torch.Tensor], mesh: Mesh, axis: str,
             send_to: Optional[int], recv_from: Optional[int],
             like: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Point to point along `axis`, in one ``dist.batch_isend_irecv``:
    sends `x` to index `send_to` and returns what index `recv_from` sent
    (a tensor of `like`'s shape and dtype, `x`'s where `like` is None).
    Either side may be None.  Every send must meet its receive on the
    other rank."""
    line = mesh.group(axis)
    if line is None:
        raise ValueError("exchange needs a process group")
    group, ranks = line
    ref = like if like is not None else x
    host = _via_host(group, ref)
    ops: List[dist.P2POp] = []
    if send_to is not None:
        out_buf = (x.cpu() if host else x).contiguous()
        ops.append(dist.P2POp(dist.isend, out_buf, ranks[send_to], group))
    recv = None
    if recv_from is not None:
        recv = torch.empty(ref.shape, dtype=ref.dtype,
                           device="cpu" if host else ref.device)
        ops.append(dist.P2POp(dist.irecv, recv, ranks[recv_from], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is not None and host:
        recv = recv.to(ref.device)
    return recv


# ----------------------------------------------------------------------
# ciphertext batches on the mesh
# ----------------------------------------------------------------------
def limb_range(mesh: Mesh, k: int) -> tuple:
    """[lo, hi) of this rank's limbs when k limbs are split over tp (a
    mesh without tp has one rank on it)."""
    tp = mesh.shape.get("tp", 1)
    if k % tp:
        raise ValueError(f"k={k} limbs not divisible by tp={tp}")
    j = mesh.axis_index("tp") if "tp" in mesh.shape else 0
    return j * (k // tp), (j + 1) * (k // tp)


def shard_ct_batch(batch, mesh: Mesh,
                   shard_limbs: bool = False) -> torch.Tensor:
    """This rank's shard of a (B, size, k, n) ciphertext batch (numpy
    uint64 or an int64 tensor): B split over dp and, with `shard_limbs`, k
    over tp; an int64 tensor on the mesh's device.  From numpy only the
    shard is moved.  Raises ValueError where B is not a multiple of dp or
    k not one of tp."""
    dp = mesh.axis_size("dp")
    if batch.ndim != 4:
        raise ValueError(f"expected a (B, size, k, n) batch, got shape "
                         f"{tuple(batch.shape)}")
    B, k = batch.shape[0], batch.shape[2]
    if B % dp:
        raise ValueError(f"batch of {B} not divisible by dp={dp}")
    i = mesh.axis_index("dp")
    lo, hi = limb_range(mesh, k) if shard_limbs else (0, k)
    return replicate(batch[i * (B // dp):(i + 1) * (B // dp), :, lo:hi],
                     mesh)


def gather_ct_batch(shard: torch.Tensor, mesh: Mesh,
                    shard_limbs: bool = False) -> torch.Tensor:
    """The inverse of ``shard_ct_batch``: the limbs all-gathered over tp
    (with `shard_limbs`), then the batch over dp; the full batch on every
    rank."""
    if shard_limbs:
        shard = all_gather_axis(shard, mesh, "tp", dim=2)
    return all_gather_axis(shard, mesh, "dp", dim=0)


def replicate(x, mesh: Mesh) -> torch.Tensor:
    """`x` (numpy uint64 or a tensor) whole and contiguous on the mesh's
    device."""
    if isinstance(x, np.ndarray):
        return convert.from_numpy(x, mesh.device)
    return x.to(mesh.device).contiguous()


# ----------------------------------------------------------------------
# faults: every rank fails together
# ----------------------------------------------------------------------
class RankFault(RuntimeError):
    """A step failed on a rank of the mesh; raised on every rank of it
    (``checked``)."""


def all_ranks(ok: bool, mesh: Mesh) -> bool:
    """Whether `ok` holds on every rank of the mesh: a MIN all-reduce of
    a flag along each axis in turn (on the card under NCCL, in host memory
    under gloo).  Every rank of the mesh calls it."""
    flag = torch.tensor([int(ok)], dtype=torch.int32)
    for axis in mesh.shape:
        line = mesh.group(axis)
        if line is None:
            continue
        group, _ranks = line
        buf = flag.to(mesh.device) if dist.get_backend(group) == "nccl" \
            else flag
        dist.all_reduce(buf, op=dist.ReduceOp.MIN, group=group)
        flag = buf.cpu()
    return bool(flag.item())


def checked(mesh: Mesh, fn):
    """``fn()`` on this rank, then ``all_ranks`` on its success: its
    result, or ``RankFault`` on every rank if it raised on any (chained to
    this rank's own exception, where it had one).

    Wraps each local step between two collectives.  A rank that left a
    step early and skipped a collective that the others entered would
    pair its next collective with theirs, and shards of one shape then mix
    without an error; after ``checked`` every rank has entered the same
    collectives."""
    try:
        out, err = fn(), None
    except Exception as exc:
        out, err = None, exc
    if not all_ranks(err is None, mesh):
        raise RankFault(f"a step failed on a rank of mesh {mesh.shape}"
                        f"{'' if err is None else ' (this one)'}") from err
    return out

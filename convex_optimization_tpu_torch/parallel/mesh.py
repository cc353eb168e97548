"""The port's counterpart of the JAX package's mesh: a process group.

Counterpart of ``convex_optimization_tpu/parallel/mesh.py``.  A JAX mesh
names the devices of one program; here every rank is a process of its
own, so the column-sharded solvers take a ``ColumnGroup``: the
``torch.distributed`` process group, this process's rank and the group's
size, the backend, and the device this rank solves on.  The production
layout is one rank per card over NCCL; gloo serves CPU tensors (the
tests) and, where a card is shared by several ranks, CUDA tensors.
Nothing picks the device for the caller.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

BLOCKS = "blocks"   # feature/column axis (the primary strategy)
ROWS = "rows"       # sample/row axis (not ported yet)


@dataclasses.dataclass(frozen=True)
class ColumnGroup:
    """The ranks that share A's columns (the mesh axis ``BLOCKS``)."""

    group: object             # the ProcessGroup (None: the default group)
    rank: int                 # this process's rank in the group
    size: int                 # ranks in the group
    backend: str              # "nccl" or "gloo"
    device: torch.device      # where this rank's slab and vectors live
    global_ranks: tuple       # global rank of each group rank

    @property
    def axis(self) -> str:
        return BLOCKS


def column_group(device, group=None) -> ColumnGroup:
    """This process's ColumnGroup in ``group`` (default: every process of
    the initialized default group), solving on ``device``."""
    pg = dist.group.WORLD if group is None else group
    size = dist.get_world_size(pg)
    return ColumnGroup(
        group=group, rank=dist.get_rank(pg), size=size,
        backend=str(dist.get_backend(pg)), device=torch.device(device),
        global_ranks=tuple(dist.get_global_rank(pg, r) for r in range(size)))


def init_multihost(init_method: str, rank: int, world_size: int, device, *,
                   backend: str | None = None,
                   timeout_s: float = 300.0) -> ColumnGroup:
    """``init_process_group`` for one rank, then its ColumnGroup.

    ``init_method``: ``"tcp://host:port"`` or ``"file:///path"`` (nothing
    on the machine names a cluster: the caller gives the address, the
    world size and the rank).  ``backend`` defaults to NCCL for a CUDA
    ``device`` (bound to it through ``device_id``) and gloo for the CPU;
    gloo on a CUDA device runs several ranks on one card.  A collective
    that waits longer than ``timeout_s`` raises instead of hanging."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = dict(backend=backend, init_method=init_method, rank=rank,
              world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return column_group(device)

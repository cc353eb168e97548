"""The port's counterpart of the JAX package's mesh: process groups.

Counterpart of ``convex_optimization_tpu/parallel/mesh.py`` and of
``grid_sharded.make_grid_mesh``.  A JAX mesh names the devices of one
program; here every rank is a process of its own, so the sharded solvers
take a group of ranks: the ``torch.distributed`` process group, this
process's rank and the group's size, the backend, and the device this
rank solves on.  A ``ColumnGroup`` splits A's columns over its ranks (the
axis ``BLOCKS``), a ``RowGroup`` its rows (``ROWS``), and a ``GridGroup``
tiles A over R x C ranks (both axes).  The production layout is one rank
per card over NCCL; gloo serves CPU tensors (the tests) and, where a card
is shared by several ranks, CUDA tensors.  Nothing picks the device for
the caller.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

BLOCKS = "blocks"   # feature/column axis (the primary strategy)
ROWS = "rows"       # sample/row axis (best when m >> n)
GRID = (ROWS, BLOCKS)   # both: A tiled over a rows x blocks grid


@dataclasses.dataclass(frozen=True)
class Group:
    """Ranks that meet at collectives (``parallel/collectives.py``)."""

    group: object             # the ProcessGroup (None: the default group)
    rank: int                 # this process's rank in the group
    size: int                 # ranks in the group
    backend: str              # "nccl" or "gloo"
    device: torch.device      # where this rank's shard and vectors live
    global_ranks: tuple       # global rank of each group rank

    @property
    def axis(self):
        return None


@dataclasses.dataclass(frozen=True)
class ColumnGroup(Group):
    """The ranks that share A's columns (the mesh axis ``BLOCKS``)."""

    @property
    def axis(self) -> str:
        return BLOCKS


@dataclasses.dataclass(frozen=True)
class RowGroup(Group):
    """The ranks that share A's rows and b (the mesh axis ``ROWS``); x is
    replicated on every rank."""

    @property
    def axis(self) -> str:
        return ROWS


def check_group(g) -> None:
    """Raise unless ``g`` (the ``mesh`` of ``solve``/``lambda_path``) is
    a ColumnGroup, RowGroup or GridGroup."""
    if getattr(g, "axis", None) not in (BLOCKS, ROWS, GRID):
        raise TypeError("mesh must be a ColumnGroup, RowGroup or GridGroup "
                        f"(parallel/mesh.py), got {type(g).__name__}")


def _describe(cls, device, group):
    pg = dist.group.WORLD if group is None else group
    size = dist.get_world_size(pg)
    return cls(
        group=group, rank=dist.get_rank(pg), size=size,
        backend=str(dist.get_backend(pg)), device=torch.device(device),
        global_ranks=tuple(dist.get_global_rank(pg, r) for r in range(size)))


def column_group(device, group=None) -> ColumnGroup:
    """This process's ColumnGroup in ``group`` (default: every process of
    the initialized default group), solving on ``device``."""
    return _describe(ColumnGroup, device, group)


def row_group(device, group=None) -> RowGroup:
    """This process's RowGroup in ``group`` (default: every process of
    the initialized default group), solving on ``device``."""
    return _describe(RowGroup, device, group)


@dataclasses.dataclass(frozen=True)
class GridGroup:
    """R x C ranks tiling A: rank k holds the tile (k // C, k % C), as
    the JAX package's ``make_grid_mesh`` places devices."""

    rows: RowGroup        # the R ranks of this rank's column shard: the
                          # ROWS all-reduces; rows.rank is its row shard
    blocks: ColumnGroup   # the C ranks of this rank's row shard: the
                          # BLOCKS all-reduces; blocks.rank its column shard
    world: Group          # all R * C ranks (the rank-0 broadcast)

    @property
    def axis(self) -> tuple:
        return GRID

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def backend(self) -> str:
        return self.world.backend


def check_grid_size(rows: int, cols: int, P: int) -> None:
    """Raise unless a rows x cols grid spans P ranks (the JAX package's
    text where there are too few)."""
    if P < rows * cols:
        raise ValueError(f"need {rows * cols} devices, have {P}")
    if P != rows * cols:
        raise ValueError(f"a {rows} x {cols} grid spans {rows * cols} "
                         f"ranks; the group has {P}")


def grid_group(rows: int, cols: int, device) -> GridGroup:
    """This process's GridGroup on a rows x cols grid of every process of
    the initialized default group.  Every rank builds every sub-group, in
    the same order (``new_group`` is collective: ranks that build them in
    different orders deadlock)."""
    check_grid_size(rows, cols, dist.get_world_size())
    r, c = divmod(dist.get_rank(), cols)
    by_col = [dist.new_group([i * cols + j for i in range(rows)])
              for j in range(cols)]
    by_row = [dist.new_group([i * cols + j for j in range(cols)])
              for i in range(rows)]
    return GridGroup(rows=row_group(device, by_col[c]),
                     blocks=column_group(device, by_row[r]),
                     world=_describe(Group, device, None))


def init_multihost(init_method: str, rank: int, world_size: int, device, *,
                   backend: str | None = None,
                   timeout_s: float = 300.0) -> ColumnGroup:
    """``init_process_group`` for one rank, then its ColumnGroup.

    ``init_method``: ``"tcp://host:port"`` or ``"file:///path"`` (nothing
    on the machine names a cluster: the caller gives the address, the
    world size and the rank).  ``backend`` defaults to NCCL for a CUDA
    ``device`` (bound to it through ``device_id``) and gloo for the CPU;
    gloo on a CUDA device runs several ranks on one card.  A collective
    that waits longer than ``timeout_s`` raises instead of hanging.  The
    row and grid layouts take ``row_group`` / ``grid_group`` of the same
    process group."""
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

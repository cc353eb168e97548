"""Residual-consensus collectives over ``torch.distributed``.

Counterpart of ``convex_optimization_tpu/parallel/collectives.py``: the
flat ``psum`` (one all-reduce), the ring all-reduce of P - 1
neighbour-to-neighbour steps, the same ring over independent chunks, and
reduce-scatter + all-gather, plus ``pmax`` and the broadcast from group
rank 0 that the sharded check needs.  Each takes the ``ColumnGroup`` of
``parallel/mesh.py``.  ``psum`` and ``pmax`` reduce in place, into the
buffer they are given (the solvers pass buffers they own), and return it.

The ring's ``async_op=True`` returns a ``Pending`` whose ``wait()`` gives
the sum: the ring's first step is in flight until then, so the caller can
launch work that does not depend on it (the ring-consensus BCD sweeps its
second half-slab meanwhile).

Backends: NCCL takes every op here on CUDA tensors, gloo every op on CPU
tensors.  gloo on CUDA tensors (several ranks sharing one card) takes the
all-reduces, the broadcast and the all-gather; its point-to-point ops
and its reduce-scatter fail there, closing the group's connections or
aborting the process (H100 runs, PERF.md), so the ring and the
reduce-scatter raise up front for that pair instead.  Nothing is moved to
the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from convex_optimization_tpu_torch.parallel.mesh import ColumnGroup

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Pending:
    """A collective in flight; ``wait()`` returns its result."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def _done(x: torch.Tensor) -> Pending:
    return Pending(lambda: x)


def _refuse_gloo_cuda(x: torch.Tensor, g: ColumnGroup, what: str) -> None:
    if g.backend == "gloo" and x.is_cuda:
        raise RuntimeError(
            f"gloo takes no CUDA tensors for {what}: run it over NCCL (one "
            "rank per card) or on CPU tensors")


def psum(x: torch.Tensor, g: ColumnGroup) -> torch.Tensor:
    """All-reduce(sum), in place."""
    dist.all_reduce(x, group=g.group)
    return x


def pmax(x: torch.Tensor, g: ColumnGroup) -> torch.Tensor:
    """All-reduce(max), in place."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g.group)
    return x


def broadcast0(x: torch.Tensor, g: ColumnGroup) -> torch.Tensor:
    """Group rank 0's ``x`` on every rank, in place."""
    dist.broadcast(x, src=g.global_ranks[0], group=g.group)
    return x


def ring_psum(x: torch.Tensor, g: ColumnGroup, async_op: bool = False):
    """All-reduce(sum) as P - 1 ring steps: each sends its running buffer
    to the right neighbour and adds what the left one sent, in the JAX
    package's order, acc = ((x + x_left) + x_left2) + ...  The ranks'
    sums differ in rounding, as on the TPU.  ``x`` is not modified."""
    n = g.size
    if n == 1:
        return _done(x) if async_op else x
    _refuse_gloo_cuda(x, g, "the ring's point-to-point steps")
    right = g.global_ranks[(g.rank + 1) % n]
    left = g.global_ranks[(g.rank - 1) % n]

    def send(buf):
        recv = torch.empty_like(buf)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, right, g.group),
            dist.P2POp(dist.irecv, recv, left, g.group)])
        return recv, works

    first = send(x)

    def finish():
        acc = x.clone()
        recv, works = first
        for step in range(n - 1):
            if step:
                recv, works = send(recv)
            for w in works:
                w.wait()
            acc += recv
        return acc
    return Pending(finish) if async_op else finish()


def ring_psum_chunked(x: torch.Tensor, g: ColumnGroup, n_chunks: int = 2,
                      async_op: bool = False):
    """The ring over ``n_chunks`` independent pieces of ``x`` (ragged
    lengths allowed), all in flight at once, then concatenated."""
    if n_chunks <= 1:
        return ring_psum(x, g, async_op)
    parts = [ring_psum(p, g, async_op=True)
             for p in torch.tensor_split(x, n_chunks)]

    def finish():
        return torch.cat([p.wait() for p in parts])
    return Pending(finish) if async_op else finish()


def reduce_scatter_gather(x: torch.Tensor, g: ColumnGroup) -> torch.Tensor:
    """All-reduce(sum) as reduce-scatter then all-gather: the sum briefly
    lives sharded, each rank owning len/P entries.  A length P does not
    divide goes to ``psum`` (of a copy), as in the JAX package."""
    n = g.size
    if n == 1:
        return x
    if x.shape[0] % n:
        return psum(x.clone(), g)
    _refuse_gloo_cuda(x, g, "reduce-scatter")
    shard = torch.empty((x.shape[0] // n,), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(shard, x, group=g.group)
    out = torch.empty_like(x)
    _all_gather(out, shard, group=g.group)
    return out


def all_gather(x: torch.Tensor, g: ColumnGroup) -> torch.Tensor:
    """The ranks' equal-length vectors, concatenated in rank order."""
    if g.size == 1:
        return x
    out = torch.empty((g.size * x.shape[0],), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=g.group)
    return out

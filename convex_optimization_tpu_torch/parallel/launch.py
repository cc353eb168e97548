"""Start P ranks of one job on this machine, each joined to one process
group: how the tests and ``chip_smoke.py`` run the column-sharded solvers
without a cluster.  The JAX package needs no launcher: one program drives
every device of its mesh (``convex_optimization_tpu/parallel/mesh.py``).

``run_ranks(job, P, tmp_dir, *args, device=...)`` spawns P processes;
rank r calls ``init_multihost("file://<tmp_dir>/store", r, P, device,
backend=...)``, runs ``job(group, *args)`` and pickles its result to
``tmp_dir``; the caller gets the results in rank order.  ``job`` must be
importable by a spawned process (a module-level function).  A ``file://``
store needs no TCP port, so parallel callers cannot clash.  A rank that
does not finish within ``timeout_s`` is killed and the launch raises (a
hung collective fails the caller instead of stalling it); a rank's
exception is raised with its traceback.  CPU tensors in ``args`` that
were made shared (``Tensor.share_memory_()``) reach the ranks as that
shared memory, not as copies.
"""

from __future__ import annotations

import os
import pickle
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(job, rank: int, P: int, tmp_dir: str, device: str,
               backend: str | None, collective_timeout_s: float,
               threads: int, args: tuple) -> None:
    out = os.path.join(tmp_dir, f"rank{rank}.pkl")
    try:
        import torch.distributed as dist

        from convex_optimization_tpu_torch.parallel.mesh import (
            init_multihost,
        )

        torch.set_num_threads(threads)
        g = init_multihost(f"file://{os.path.join(tmp_dir, 'store')}", rank,
                           P, device, backend=backend,
                           timeout_s=collective_timeout_s)
        try:
            result = ("ok", job(g, *args))
        finally:
            dist.destroy_process_group()
    except Exception:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(job, P: int, tmp_dir, *args, device: str,
              backend: str | None = None, timeout_s: float = 600.0,
              collective_timeout_s: float = 120.0,
              threads: int | None = None) -> list:
    """Results of ``job(group, *args)`` on P spawned ranks, in rank order.
    ``device``: where every rank solves ("cuda:0", or "cpu"); the caller
    names it.  ``backend`` defaults as ``init_multihost``'s (gloo for the
    CPU; pass "gloo" to share one card among the ranks).  ``threads``: torch
    threads per rank, by default the machine's cores split over the
    ranks (P ranks that each take every core spin against each other,
    and their small ops slow down many times over)."""
    tmp_dir = os.fspath(tmp_dir)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // P)
    os.makedirs(tmp_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, P, tmp_dir, device, backend,
                               collective_timeout_s, threads, args))
             for r in range(P)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {P} did not finish in "
                           f"{timeout_s} s")
    results = []
    for r in range(P):
        path = os.path.join(tmp_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} exited ({procs[r].exitcode}) "
                               "without a result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results

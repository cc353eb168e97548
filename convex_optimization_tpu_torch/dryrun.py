"""Entry points of a compile-and-run check and a multi-rank dry run.

Counterpart of ``__graft_entry__.py``, the JAX package's entry
points (its dry run drives ``convex_optimization_tpu/parallel/
sharded.py``'s ``solve_sharded`` on a virtual CPU mesh): ``entry()``
returns the port's flagship step, one FISTA iteration (K3, the prox, K2)
on a 256 x 1024 lasso instance, with its arguments; ``dryrun_multichip(n)``
spawns n gloo ranks on the CPU (``parallel/launch.run_ranks``) and runs,
in every rank, one step of each sharded solver at tiny shapes: the
column-sharded BCD and FISTA, the ring consensus with the split sweep,
the reduce-scatter FISTA, the group BCD, the 3-point batched path, the
row-sharded FISTA and BCD, and, for an even n, the grid-sharded FISTA
and BCD on 2 x n/2 ranks.  It runs on the CPU, as the JAX dry run does,
because gloo takes the ring's and the reduce-scatter's collectives on
CPU tensors only (``parallel/collectives.py``).

    python -m convex_optimization_tpu_torch.dryrun 8
    python -m convex_optimization_tpu_torch.dryrun entry [cpu]
"""

from __future__ import annotations

import importlib
import sys
import tempfile


def entry(device=None):
    """(fn, args): one FISTA step ``fn(problem, L_total, state)`` on a
    256 x 1024 lasso instance on ``device`` (default: the card)."""
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops.matvec import spectral_norm_sq_t
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.solvers.fista import (
        fista_step,
        init_state,
    )

    cfg = SolverConfig()
    problem = make_lasso_instance_host(0, 256, 1024, device=device)[0].problem
    problem = problem.with_lam1(float(problem.penalty.lam1))
    L_total = float(spectral_norm_sq_t(problem.A_t)) + problem.lam2
    state = init_state(problem, None)

    def fn(problem, L_total, state):
        return fista_step(problem, L_total, state, cfg)

    return fn, (problem, L_total, state)


def _rank_job(g) -> dict:
    """One rank of the dry run: the JAX dry run's list of sharded steps;
    returns each run's x shape and its method name."""
    from convex_optimization_tpu_torch.api import solve
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.models.penalties import group_l2
    from convex_optimization_tpu_torch.parallel.mesh import (
        grid_group,
        row_group,
    )
    from convex_optimization_tpu_torch.solvers.batched_path import (
        batched_lambda_path,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    P, out = g.size, {}

    def run(name, problem, method, group, **kw):
        res = solve(problem, method, mesh=group, **kw)
        out[name] = (tuple(res.x.shape), res.method)

    n = 64 * P
    p = make_lasso_instance_host(0, 32, n, device="cpu")[0].problem
    run("bcd", p, "bcd", g, max_iters=1, gap_every=1, block_size=32)
    run("fista", p, "fista", g, max_iters=1, gap_every=1)
    run("ring", p, "bcd", g, max_iters=2, gap_every=1, block_size=16,
        consensus="ring")
    run("reduce_scatter", p, "fista", g, max_iters=1, gap_every=1,
        consensus="reduce_scatter")
    gp = p.with_penalty(group_l2(float(p.penalty.lam1), ngroups=8 * P))
    run("group", gp, "bcd", g, max_iters=1, gap_every=1, block_size=16)

    n_b = 128 * P
    pb = make_lasso_instance_host(3, 32, n_b, device="cpu")[0].problem
    br = batched_lambda_path(
        pb, SolverConfig(max_iters=2, gap_every=1, stall_checks=2),
        path_len=3, mesh=g)
    out["batched_path"] = (tuple(br.xs.shape), br.method_used)

    pr = make_lasso_instance_host(1, 8 * P, 64, device="cpu")[0].problem
    rg = row_group(g.device)
    run("rows_fista", pr, "fista", rg, max_iters=1, gap_every=1)
    run("rows_bcd", pr, "bcd", rg, max_iters=1, gap_every=1, block_size=16)

    if P % 2 == 0:
        n_g = 32 * (P // 2)
        pg = make_lasso_instance_host(2, 16, n_g, device="cpu")[0].problem
        gg = grid_group(2, P // 2, g.device)
        run("grid_fista", pg, "fista", gg, max_iters=1, gap_every=1)
        run("grid_bcd", pg, "bcd", gg, max_iters=1, gap_every=1,
            block_size=16)
    return out


def expected(P: int) -> dict:
    """What every rank of ``dryrun_multichip(P)`` must return."""
    n = 64 * P
    want = {"bcd": ((n,), "sharded_bcd"), "fista": ((n,), "sharded_fista"),
            "ring": ((n,), "sharded_bcd"),
            "reduce_scatter": ((n,), "sharded_fista"),
            "group": ((n,), "sharded_bcd"),
            "batched_path": ((3, 128 * P), "bcd_batch+sharded"),
            "rows_fista": ((64,), "row_sharded_fista"),
            "rows_bcd": ((64,), "row_sharded_bcd")}
    if P % 2 == 0:
        n_g = 32 * (P // 2)
        want["grid_fista"] = ((n_g,), "grid_sharded_fista")
        want["grid_bcd"] = ((n_g,), "grid_sharded_bcd")
    return want


def dryrun_multichip(n_ranks: int, timeout_s: float = 600.0) -> None:
    """One step of every sharded solver on ``n_ranks`` gloo ranks on the
    CPU (tiny shapes); raises if a rank fails, hangs past ``timeout_s``
    or returns another shape or method than ``expected``."""
    from convex_optimization_tpu_torch.parallel.launch import run_ranks

    # the job by its module's name, so that the spawned ranks find it
    # when this module runs as __main__
    job = importlib.import_module(
        "convex_optimization_tpu_torch.dryrun")._rank_job
    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(job, n_ranks, tmp, device="cpu", backend="gloo",
                            timeout_s=timeout_s)
    want = expected(n_ranks)
    for rank, got in enumerate(results):
        if got != want:
            raise AssertionError(f"rank {rank}: {got} != {want}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "entry":
        fn, args = entry(sys.argv[2] if len(sys.argv) > 2 else None)
        out = fn(*args)
        print("entry() run OK", tuple(out.x.shape))
    else:
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
        dryrun_multichip(n)
        print(f"dryrun_multichip({n}) OK")

"""Command-line driver of the port.

Counterpart of ``convex_optimization_tpu/cli.py``: the same flags, choices
and defaults (the five BASELINE.md contract configs, ``--config
config1..5``, plus custom sizes), the same JSON line keys for a solve, a
lambda path and CV, JSONL metrics, snapshots and resume, plus ``--device``.

    python -m convex_optimization_tpu_torch.cli --config config3 --method bcd_pallas --polish
    python -m convex_optimization_tpu_torch.cli --config config1 --ci --device cpu
    python -m convex_optimization_tpu_torch.cli --config config2 --jsonl out.jsonl
    python -m convex_optimization_tpu_torch.cli --config config5 --ci --mesh 1 --method bcd_pallas
    python -m convex_optimization_tpu_torch.cli --config config3 --ci --device cpu --mesh 2
    python -m convex_optimization_tpu_torch.cli --config config2 --ci --device cpu --mesh 2 --lambda-path 4
    python -m convex_optimization_tpu_torch.cli --config config1 --ci --device cpu --mesh 2 --mesh-axis rows

Every instance, named config or custom size, is drawn by the host
generator (``core/datagen.make_lasso_instance_host``), whose numbers equal
the JAX package's host generator for the same seed; the JAX CLI draws by
``jax.random`` unless it polishes a separable penalty.  The host copies
of A and b feed the polish.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="convex_optimization_tpu_torch",
        description="sparse-regression solver driver (PyTorch/CUDA port)",
    )
    p.add_argument("--config", choices=["config1", "config2", "config3",
                                        "config4", "config5"],
                   help="named BASELINE.md benchmark config")
    p.add_argument("--ci", action="store_true",
                   help="run the CI-sized twin of the named config")
    p.add_argument("--m", type=int, help="rows (custom size)")
    p.add_argument("--n", type=int, help="columns (custom size)")
    p.add_argument("--penalty", default=None,
                   choices=["l1", "nonneg_l1", "group_l2"])
    p.add_argument("--ngroups", type=int, default=0)
    p.add_argument("--lam1-frac", type=float, default=0.1,
                   help="lam1 as a fraction of lambda_max")
    p.add_argument("--lam2", type=float, default=0.0,
                   help="ridge coefficient (elastic net)")
    p.add_argument("--method", default="fista",
                   choices=["fista", "ista", "bcd", "bcd_pallas", "admm",
                            "fista_ws", "bcd_ws", "bcd_batch"])
    p.add_argument("--cv-method", default="bcd_batch",
                   choices=["bcd_batch", "fista", "ista", "bcd",
                            "bcd_pallas"],
                   help="solver for --cv fold paths (bcd_batch = K5-K7 "
                        "folds sharing one resident A)")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-iters", type=int, default=10_000)
    p.add_argument("--gap-every", type=int, default=10)
    p.add_argument("--screen", action="store_true",
                   help="enable gap-safe screening")
    p.add_argument("--lambda-path", type=int, default=0,
                   help="run a warm-started geometric path of this length")
    p.add_argument("--path-compact", action="store_true",
                   help="per-lambda gap-safe compaction along the path")
    p.add_argument("--cv", type=int, default=0, metavar="K",
                   help="K-fold cross-validation over the lambda path "
                        "(picks lambda by held-out MSE; path length from "
                        "--lambda-path, default 10)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard A over this many ranks: one per card over "
                        "NCCL, or gloo ranks with --device cpu; a solve "
                        "(screened with --screen or config 3) or a "
                        "--lambda-path runs on the slabs")
    p.add_argument("--mesh-axis", default="blocks",
                   choices=["blocks", "rows"],
                   help="blocks = column sharding (an m-vector all-reduce "
                        "per step); rows = row sharding (an n-vector "
                        "all-reduce per step: the layout when m >> n)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jsonl", help="write per-check metrics to this file")
    p.add_argument("--checkpoint", help="write a snapshot here after solving")
    p.add_argument("--resume", action="store_true",
                   help="warm-start from --checkpoint if it exists")
    p.add_argument("--polish", action="store_true",
                   help="finish with the f64 certification phase "
                        "(solvers/polish.py polish_support)")
    p.add_argument("--stall-checks", type=int, default=0,
                   help="exit after this many gap checks without a new "
                        "best (f32 noise-floor detection)")
    p.add_argument("--f64", action="store_true",
                   help="float64 instance on the chosen device (the CPU "
                        "verification path: the kernels take float32)")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity) of the solve and its --polish to "
                        "DIR/trace.json, with the port's cot. spans "
                        "(utils/trace.py) around the operators they issue")
    p.add_argument("--plot", metavar="PNG",
                   help="write the error-vs-iteration convergence plot "
                        "(or the per-lambda path summary, or the CV curve) "
                        "here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the instance lives and every solver runs "
                        "(default: the card; never falls back to the CPU)")
    return p


def _axis_group(g, axis: str):
    """The group of ``--mesh-axis`` over the ranks of ``g`` (the column
    group every rank joins)."""
    if axis == "rows":
        from convex_optimization_tpu_torch.parallel.mesh import row_group

        return row_group(g.device)
    return g


def _mesh_rank_job(g, problem, axis: str, method: str, solve_kw: dict, x0):
    """One rank of ``--mesh``: the sharded solve on this rank's device.
    Returns (the Result with x on the CPU, rank 0 only; this rank's kernel
    launch counts)."""
    from convex_optimization_tpu_torch.api import solve
    from convex_optimization_tpu_torch.ops import _build

    g = _axis_group(g, axis)
    problem = problem.to(g.device)
    if x0 is not None:
        x0 = x0.to(g.device)
    res = solve(problem, method, mesh=g, x0=x0, **solve_kw)
    if g.rank != 0:
        res = None
    else:
        res = dataclasses.replace(res, x=res.x.cpu())
    return res, dict(_build.launches)


def _mesh_path_rank_job(g, problem, axis: str, cfg, path_kw: dict):
    """One rank of ``--mesh --lambda-path``: the sharded path on this
    rank's device.  Returns (the PathResult on the CPU, rank 0 only; this
    rank's kernel launch counts)."""
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.lambda_path import lambda_path

    g = _axis_group(g, axis)
    pr = lambda_path(problem.to(g.device), cfg, mesh=g, **path_kw)
    if g.rank != 0:
        pr = None
    else:
        pr = pr._replace(lambdas=pr.lambdas.cpu(), xs=pr.xs.cpu(),
                         gaps=pr.gaps.cpu(), iters=pr.iters.cpu(),
                         converged=pr.converged.cpu())
    return pr, dict(_build.launches)


def _solve_mesh(problem, P: int, device, axis: str, solve_kw: dict):
    """The sharded solve over P spawned ranks (``_run_mesh``) on the
    ``--mesh-axis`` layout."""
    kw = dict(solve_kw)
    method, x0 = kw.pop("method"), kw.pop("x0", None)
    if x0 is not None:
        x0 = x0.cpu()
    return _run_mesh(problem, P, device, _mesh_rank_job, axis, method, kw,
                     x0)


def _run_mesh(problem, P: int, device, job, *args):
    """Rank 0's result of ``job(group, problem, *args)`` over P spawned
    ranks (one per card over NCCL, or gloo ranks on the CPU), the problem
    passed as shared memory.  The ranks' kernel launches are added to
    this process's counts (``ops/_build.launches``): they ran on its
    behalf."""
    import torch

    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.parallel.launch import run_ranks

    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if P > visible:
            raise ValueError(f"--mesh {P} needs {P} cards, {visible} visible")
        devices = [f"cuda:{r}" for r in range(P)]
    else:
        devices = "cpu"
    shared = dataclasses.replace(
        problem.to("cpu"),
        A_t=problem.A_t.to("cpu", copy=True).share_memory_(),
        b=problem.b.to("cpu", copy=True).share_memory_())
    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(job, P, tmp, shared, *args, device=devices)
    for _, launches in results:
        _build.launches.update(launches)
    return results[0][0]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from convex_optimization_tpu_torch.api import solve
    from convex_optimization_tpu_torch.core.datagen import (
        BENCH_CONFIGS,
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.utils import checkpoint as ckpt
    from convex_optimization_tpu_torch.utils import metrics as M
    from convex_optimization_tpu_torch.utils.device import require_cuda

    device = (torch.device("cpu") if args.device == "cpu"
              else require_cuda())
    dtype = torch.float64 if args.f64 else torch.float32

    if args.config:
        cfg = BENCH_CONFIGS[args.config]
        name = cfg.name + ("-ci" if args.ci else "")
        lambda_path = args.lambda_path or cfg.lambda_path
        screen = args.screen or cfg.screening
    elif args.m and args.n:
        cfg = None
        name = f"custom-{args.m}x{args.n}"
        lambda_path = args.lambda_path
        screen = args.screen
    else:
        print("either --config or both --m/--n are required",
              file=sys.stderr)
        return 2
    mesh_n = args.mesh

    if cfg is not None:
        inst, A_host, b_host = cfg.instance_host(
            args.seed, ci=args.ci, device=device, dtype=dtype)
    else:
        inst, A_host, b_host = make_lasso_instance_host(
            args.seed, args.m, args.n, penalty_kind=args.penalty or "l1",
            ngroups=args.ngroups, lam1_frac=args.lam1_frac, lam2=args.lam2,
            device=device)
        if args.f64:
            inst = inst._replace(problem=inst.problem.to(dtype=dtype))
    problem = inst.problem
    solve_kw: dict = dict(
        method=args.method, tol=args.tol, max_iters=args.max_iters,
        gap_every=args.gap_every,
    )
    if args.stall_checks:
        solve_kw["stall_checks"] = args.stall_checks
    if screen:
        solve_kw["screen_every"] = 1

    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        snap = ckpt.load_snapshot(args.checkpoint)
        solve_kw["x0"] = torch.as_tensor(snap.x, dtype=problem.dtype,
                                         device=device)
        problem = problem.with_lam1(snap.lam1)
        print(f"resumed from {args.checkpoint} (lam_index="
              f"{snap.lam_index})", file=sys.stderr)

    scfg = SolverConfig(max_iters=args.max_iters, tol=args.tol,
                        gap_every=args.gap_every,
                        screen_every=1 if screen else 0,
                        stall_checks=args.stall_checks)
    if args.cv:
        from convex_optimization_tpu_torch.solvers.cv import cv_lambda_path

        with M.WallTimer(device) as t:
            cvres = cv_lambda_path(
                problem, scfg, k=args.cv, path_len=lambda_path or 10,
                seed=args.seed, method=args.cv_method)
        out = {
            "name": name, "mode": "cv", "k": args.cv,
            "method_used": cvres.method_used,
            "wall_s": float(t),
            "lambdas": [float(v) for v in cvres.lambdas],
            "mean_mse": [float(v) for v in cvres.mean_mse],
            "se_mse": [float(v) for v in cvres.se_mse],
            "best_lambda": cvres.best_lambda,
            "one_se_lambda": cvres.one_se_lambda,
            "nnz_best": int(torch.count_nonzero(cvres.x)),
            "nnz_one_se": int(torch.count_nonzero(cvres.x_one_se)),
        }
        print(f"[{name}] cv k={args.cv}: best_lambda="
              f"{cvres.best_lambda:.4g} (mse "
              f"{float(cvres.mean_mse[cvres.best_index]):.4g}), 1-SE "
              f"lambda={cvres.one_se_lambda:.4g}, wall={float(t):.2f}s",
              file=sys.stderr)
        print(json.dumps(out))
        if args.plot:
            from convex_optimization_tpu_torch.utils.plotting import plot_cv

            if plot_cv(cvres.lambdas, cvres.mean_mse, cvres.se_mse,
                       cvres.best_lambda, cvres.one_se_lambda, args.plot,
                       title=f"{name}: {args.cv}-fold CV"):
                print(f"[{name}] wrote {args.plot}", file=sys.stderr)
        return 0

    if lambda_path:
        from convex_optimization_tpu_torch.solvers.lambda_path import (
            lambda_path as run_path,
        )

        path_kw = {}
        if args.method != "fista":
            path_kw["method"] = args.method
        if args.path_compact:
            path_kw["compact"] = True
        with M.WallTimer(device) as t:
            if mesh_n:
                pr = _run_mesh(problem, mesh_n, device, _mesh_path_rank_job,
                               args.mesh_axis, scfg,
                               dict(path_kw, path_len=lambda_path))
            else:
                pr = run_path(problem, scfg, path_len=lambda_path, **path_kw)
        nnz = torch.count_nonzero(pr.xs, dim=1).tolist()
        rows = []
        for i in range(lambda_path):
            rows.append({
                "lam1": float(pr.lambdas[i]),
                "rel_gap": float(pr.gaps[i]),
                "iters": int(pr.iters[i]),
                "nnz": int(nnz[i]),
            })
            if pr.kept is not None:
                rows[-1]["kept"] = int(pr.kept[i])
            print(f"[{name}] path[{i}] lam1={rows[-1]['lam1']:.4g} "
                  f"iters={rows[-1]['iters']} rel_gap={rows[-1]['rel_gap']:.2e} "
                  f"nnz={rows[-1]['nnz']}", file=sys.stderr)
        print(json.dumps({"name": name, "mode": "lambda_path",
                          "wall_s": float(t), "path": rows}))
        if args.plot:
            from convex_optimization_tpu_torch.utils.plotting import (
                plot_path,
            )

            if plot_path([r["lam1"] for r in rows],
                         [max(r["rel_gap"], 0.0) for r in rows],
                         [r["iters"] for r in rows],
                         [r["nnz"] for r in rows], args.plot,
                         title=f"{name}: lambda path"):
                print(f"[{name}] wrote {args.plot}", file=sys.stderr)
        if args.checkpoint:
            ckpt.save_snapshot(args.checkpoint, pr.xs[-1],
                               float(pr.lambdas[-1]),
                               lam_index=lambda_path - 1,
                               meta={"name": name})
        return 0

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    pr = None
    with prof:
        if mesh_n:
            res = _solve_mesh(problem, mesh_n, device, args.mesh_axis,
                              solve_kw)
        else:
            res = solve(problem, **solve_kw)
        if args.polish and not (res.converged and res.rel_gap <= args.tol):
            from convex_optimization_tpu_torch.solvers.polish import (
                polish_support,
            )

            pr = polish_support(problem, res.x, tol=args.tol,
                                A_host=A_host, b_host=b_host)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"[{name}] wrote {trace}", file=sys.stderr)

    M.summary_line(name, res)
    # the port times the run it counts: timed_iterations = iterations
    out = {
        "name": name, "method": res.method, "m": problem.m, "n": problem.n,
        "iterations": res.iterations, "timed_iterations": res.iterations,
        "rel_gap": res.rel_gap,
        "converged": res.converged, "wall_s": res.wall_time_s,
        "iters_per_sec": res.iters_per_sec, "nnz": res.nnz,
    }
    x_out = res.x
    if pr is not None:
        out.update({
            "polish_wall_s": pr.wall_time_s,
            "certified_rel_gap": pr.rel_gap,
            "certified": pr.rel_gap <= args.tol,
            "polish_kept": pr.kept,
        })
        x_out = pr.x
        print(f"[{name}] polish: gap={pr.rel_gap:.2e} kept={pr.kept} "
              f"wall={pr.wall_time_s:.2f}s", file=sys.stderr)
    print(json.dumps(out))

    if args.plot:
        from convex_optimization_tpu_torch.utils.plotting import (
            plot_history,
        )

        if plot_history(res.history, args.plot,
                        title=f"{name}: {res.method} "
                              f"{problem.m}x{problem.n}"):
            print(f"[{name}] wrote {args.plot}", file=sys.stderr)
    if args.jsonl:
        with open(args.jsonl, "w") as f:
            M.write_jsonl(M.records_from_history(res.history,
                                                 res.wall_time_s),
                          f, meta=out)
    if args.checkpoint:
        ckpt.save_snapshot(args.checkpoint, x_out,
                           float(problem.penalty.lam1),
                           iteration=res.iterations, meta={"name": name})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's objective values, checkpoint, metrics and plots against the
JAX package's (``core/objective.py``, ``utils/checkpoint.py``,
``utils/metrics.py``, ``utils/plotting.py``).

  * ``primal_value`` / ``dual_value`` equal the JAX package's in f64 to
    1e-12 relative, for every penalty (weighted group_l2, elastic net);
  * a snapshot crosses packages in both directions with every key equal;
    ``resume_solve`` from a snapshot of an interrupted solve lands on the
    uninterrupted solve's x (2e-4) in fewer iterations, as
    ``tests/test_utils_cli.py`` holds the JAX package;
  * ``records_from_history`` / ``write_jsonl`` write the JAX package's
    lines for the same history;
  * the plots are written, and each entry point returns False without
    matplotlib.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core import objective as jobj
from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.utils import checkpoint as jckpt
from convex_optimization_tpu.utils import metrics as JM
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core import objective as pobj
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.utils import checkpoint as ckpt
from convex_optimization_tpu_torch.utils import metrics as M
from convex_optimization_tpu_torch.utils import plotting


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0), ("nonneg_l1", 0, 1e-2), ("group_l2", 16, 0.1)])
def test_primal_and_dual_values_equal_jax(kind, ngroups, lam2):
    rng = np.random.default_rng(2)
    m, n = 40, 128
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    x = np.where(rng.random(n) < 0.3, rng.standard_normal(n), 0.0)
    if kind == "nonneg_l1":
        x = np.abs(x)
    w = (0.5 + rng.random(ngroups)).astype(np.float32) if ngroups else None
    lam1 = 0.3
    jp = JProblem(A=jnp.asarray(A, jnp.float64), b=jnp.asarray(b, jnp.float64),
                  penalty=JPenalty(lam1=lam1, kind=kind, ngroups=ngroups,
                                   weights=None if w is None
                                   else jnp.asarray(w, jnp.float64)),
                  lam2=lam2)
    pp = problem_from_numpy(A, b, kind, lam1, lam2=lam2, ngroups=ngroups,
                            weights=w, device="cpu").to(dtype=torch.float64)
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    for jf, pf in ((jobj.primal_value, pobj.primal_value),
                   (jobj.dual_value, pobj.dual_value)):
        want, got = float(jf(jp, xj)), float(pf(pp, xp))
        assert abs(got - want) <= 1e-12 * abs(want)
    r = pp.residual(xp)
    assert float(pobj.primal_value(pp, xp, r)) == float(
        pobj.primal_value(pp, xp))


def test_snapshot_crosses_packages(tmp_path):
    x = np.arange(8.0, dtype=np.float32)
    jckpt.save_snapshot(str(tmp_path / "j.npz"), x, 0.25, lam_index=3,
                        iteration=42, meta={"name": "t"})
    ckpt.save_snapshot(str(tmp_path / "p.npz"), torch.from_numpy(x), 0.25,
                       lam_index=3, iteration=42, meta={"name": "t"})
    for load in (ckpt.load_snapshot, jckpt.load_snapshot):
        for f in ("j.npz", "p.npz"):
            s = load(str(tmp_path / f))
            np.testing.assert_array_equal(s.x, x)
            assert s.x.dtype == np.float32
            assert (s.lam1, s.lam_index, s.iteration, s.meta) == \
                (0.25, 3, 42, {"name": "t"})
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_resume_is_warm_start(tmp_path):
    inst, _, _ = make_lasso_instance_host(0, 96, 384, lam1_frac=0.05,
                                          device="cpu")
    problem = inst.problem
    full = cot.solve(problem, tol=1e-5, max_iters=4000)
    assert full.converged and full.iterations > 20
    part = cot.solve(problem, tol=1e-5, max_iters=10, gap_every=10)
    assert not part.converged
    p = str(tmp_path / "mid.npz")
    ckpt.save_snapshot(p, part.x, float(problem.penalty.lam1))
    resumed = ckpt.resume_solve(problem, p, tol=1e-5, max_iters=4000)
    assert resumed.converged
    np.testing.assert_allclose(resumed.x.numpy(), full.x.numpy(), atol=2e-4)
    assert resumed.iterations < full.iterations
    assert resumed.iters_per_sec == resumed.iterations / resumed.wall_time_s


def test_records_and_jsonl_have_the_jax_format():
    inst, _, _ = make_lasso_instance_host(0, 64, 256, device="cpu")
    res = cot.solve(inst.problem, tol=1e-5, max_iters=2000)
    recs = M.records_from_history(res.history, res.wall_time_s)
    jrecs = JM.records_from_history(res.history, res.wall_time_s)
    assert len(recs) == len(res.history["iteration"]) > 0
    assert recs[-1].rel_gap <= 1e-5
    out, jout = io.StringIO(), io.StringIO()
    M.write_jsonl(recs, out, meta={"name": "t"})
    JM.write_jsonl(jrecs, jout, meta={"name": "t"})
    assert out.getvalue() == jout.getvalue()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert lines[0] == {"record": "meta", "name": "t"}
    assert len(lines) == len(recs) + 1
    assert recs[-1].t_wall_s == pytest.approx(res.wall_time_s)


def test_wall_timer_and_summary_line():
    with M.WallTimer(torch.device("cpu")) as t:
        sum(range(1000))
    assert float(t) >= 0.0
    inst, _, _ = make_lasso_instance_host(0, 64, 256, device="cpu")
    res = cot.solve(inst.problem, tol=1e-4)
    buf = io.StringIO()
    M.summary_line("t", res, extra={"k": 1}, file=buf)
    assert buf.getvalue().startswith("[t] method=fista iters=")
    assert buf.getvalue().rstrip().endswith("k=1")


def test_plots(tmp_path, monkeypatch):
    hist = {"iteration": np.arange(0, 50, 10),
            "rel_gap": np.geomspace(1e-1, 1e-6, 5),
            "primal": torch.linspace(3.0, 1.0, 5)}
    p1, p2, p3 = (str(tmp_path / f) for f in ("h.png", "p.png", "c.png"))
    assert plotting.plot_history(hist, p1, title="t")
    assert plotting.plot_path(torch.tensor([1.0, 0.1, 0.01]),
                              [1e-6, 1e-5, 1e-4], [10, 100, 1000],
                              [1, 5, 9], p2)
    assert plotting.plot_cv([1.0, 0.1, 0.01], [3.0, 1.0, 2.0],
                            [0.1, 0.1, 0.1], 0.1, 1.0, p3)
    for p in (p1, p2, p3):
        assert (tmp_path / p).stat().st_size > 0
    assert not plotting.plot_history({"iteration": []}, p1)
    monkeypatch.setattr(plotting, "_plt", lambda: None)
    assert not plotting.plot_history(hist, p1)
    assert not plotting.plot_path([1.0], [1e-6], [1], [1], p2)
    assert not plotting.plot_cv([1.0], [1.0], [0.1], 1.0, 1.0, p3)

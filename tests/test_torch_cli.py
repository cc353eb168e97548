"""The port's command-line driver (``convex_optimization_tpu_torch/cli.py``)
on the CPU, against the JAX package's CLI.

Both CLIs draw the custom-size instance by the host generator (the JAX
CLI does when it polishes a separable penalty), so they run the same A, b
and lam1.  Parity, single-device and over 2 ranks (the JAX CLI over 2 of
the conftest's 8 CPU devices, the port's over 2 gloo ranks):

  * polished (``--tol 1e-7 --max-iters 200``: the f32 solves stop above
    tol, so both CLIs run the f64 polish): both certified, the same
    support, x from the two snapshots within 1e-6 relative;
  * ``--tol 1e-6``: the f32 monitors read tol at this size before the
    polish is asked for (both CLIs then skip it), so x are two f32
    iterates: both converged, the same support, each one's f64 gap
    (``duality_gap(precise=True)``) <= 1e-5 (the f32 certificate's noise
    floor of a few 1e-6: the JAX sharded run reads 4.1e-7 in f32 at an
    f64 gap of 2.5e-6), x within 1e-5 relative.

The port CLI alone: the named configs' CI twins, a lambda path (every row
<= 1e-4 and nnz non-decreasing, as ``tests/test_utils_cli.py`` checks the
JAX CLI), CV, ``--path-compact``, ``--resume``, ``--jsonl``, ``--plot``,
``--profile``, ``--mesh 2`` with config 3's screening and with a lambda
path against the single-device CLI, ``--mesh 2 --mesh-axis rows``
against the JAX CLI's row layout, and the refusal of a run without
``--device cpu`` where there is no card.
"""

import json
import os

import numpy as np
import pytest
import torch

from convex_optimization_tpu.cli import build_parser as jax_parser
from convex_optimization_tpu.cli import main as jax_main
from convex_optimization_tpu.utils.checkpoint import (
    load_snapshot as jax_load_snapshot,
)
from convex_optimization_tpu_torch.cli import build_parser, main
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.core.objective import duality_gap
from convex_optimization_tpu_torch.utils import checkpoint as ckpt
from tests.torch_threads import worker_threads  # noqa: F401

M, N = 200, 800
CUSTOM = ["--m", str(M), "--n", str(N), "--polish", "--method",
          "bcd_pallas"]
RUNS = {"polished": ["--tol", "1e-7", "--max-iters", "200"],
        "f32": ["--tol", "1e-6"]}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port(argv, capsys) -> dict:
    assert main(["--device", "cpu", *argv]) == 0
    return _last_json(capsys)


@pytest.mark.parametrize("mesh", [0, 2])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_parity_with_jax(run, mesh, tmp_path, capsys):
    extra = RUNS[run] + (["--mesh", str(mesh)] if mesh else [])
    snaps = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "port")}
    assert jax_main(CUSTOM + extra + ["--checkpoint", snaps["jax"]]) == 0
    out_j = _last_json(capsys)
    out_p = _port(CUSTOM + extra + ["--checkpoint", snaps["port"]], capsys)
    x_j = jax_load_snapshot(snaps["jax"]).x.astype(np.float64)
    x_p = ckpt.load_snapshot(snaps["port"]).x.astype(np.float64)
    assert x_p.shape == (N,)
    np.testing.assert_array_equal(x_j != 0, x_p != 0)
    rel = np.abs(x_j - x_p).max() / np.abs(x_j).max()
    if run == "polished":
        for out in (out_j, out_p):
            assert out["certified"] and out["certified_rel_gap"] <= 1e-7
        assert rel <= 1e-6
    else:
        assert out_j["converged"] and out_p["converged"]
        assert "certified" not in out_p
        problem = make_lasso_instance_host(0, M, N, device="cpu")[0].problem
        for x in (x_j, x_p):
            gap = duality_gap(problem, torch.from_numpy(x), precise=True)
            assert float(gap.rel_gap) <= 1e-5
        assert rel <= 1e-5
    if mesh:
        assert out_p["method"] == "sharded_bcd" == out_j["method"]


def test_parser_matches_jax():
    """Every flag of the JAX CLI, with its choices and default; plus
    --device."""
    j = {a.dest: a for a in jax_parser()._actions if a.dest != "help"}
    p = {a.dest: a for a in build_parser()._actions if a.dest != "help"}
    assert set(p) == set(j) | {"device"}
    for dest, a in j.items():
        assert p[dest].option_strings == a.option_strings, dest
        assert p[dest].choices == a.choices, dest
        assert p[dest].default == a.default, dest
        assert p[dest].type == a.type, dest
    assert p["device"].choices == ["cuda", "cpu"]
    assert p["device"].default == "cuda"


def test_config1_ci_and_jsonl(tmp_path, capsys):
    jl, snap = str(tmp_path / "c.jsonl"), str(tmp_path / "c.npz")
    out = _port(["--config", "config1", "--ci", "--tol", "1e-4",
                 "--method", "bcd", "--jsonl", jl, "--checkpoint", snap],
                capsys)
    assert out["name"] == "config1-ci" and out["converged"]
    assert out["timed_iterations"] == out["iterations"] > 0
    assert out["m"] == 128 and out["n"] == 512
    lines = [json.loads(ln) for ln in open(jl).read().splitlines()]
    assert lines[0]["record"] == "meta" and lines[0]["name"] == "config1-ci"
    assert all(ln["record"] == "check" for ln in lines[1:]) and lines[1:]
    assert lines[-1]["rel_gap"] <= 1e-4
    assert ckpt.load_snapshot(snap).x.shape == (512,)


def test_config2_ci_lambda_path(capsys):
    out = _port(["--config", "config2", "--ci", "--lambda-path", "4",
                 "--tol", "1e-4"], capsys)
    assert out["mode"] == "lambda_path" and len(out["path"]) == 4
    assert all(row["rel_gap"] <= 1e-4 for row in out["path"])
    nnz = [row["nnz"] for row in out["path"]]
    assert nnz == sorted(nnz)


def test_path_compact_rows_carry_kept(capsys):
    out = _port(["--config", "config2", "--ci", "--lambda-path", "4",
                 "--tol", "1e-4", "--path-compact"], capsys)
    assert all("kept" in row and 0 < row["kept"] <= 512
               for row in out["path"])
    assert all(row["rel_gap"] <= 1e-4 for row in out["path"])


def test_cv(tmp_path, capsys):
    png = str(tmp_path / "cv.png")
    out = _port(["--config", "config1", "--ci", "--cv", "3",
                 "--lambda-path", "5", "--tol", "1e-5", "--max-iters", "2000",
                 "--plot", png],
                capsys)
    assert out["mode"] == "cv" and out["k"] == 3
    assert out["method_used"] == "bcd_batch"
    assert len(out["lambdas"]) == len(out["mean_mse"]) == 5
    assert out["best_lambda"] in out["lambdas"]
    assert out["one_se_lambda"] >= out["best_lambda"]
    assert out["nnz_one_se"] <= out["nnz_best"]
    assert os.path.getsize(png) > 0


def test_resume_warm_starts_from_the_snapshot(tmp_path, capsys):
    snap = str(tmp_path / "r.npz")
    args = ["--m", "96", "--n", "384", "--lam1-frac", "0.05", "--tol",
            "1e-5", "--max-iters", "4000", "--checkpoint", snap]
    first = _port(args, capsys)
    again = _port(args + ["--resume"], capsys)
    assert first["converged"] and again["converged"]
    assert again["iterations"] < first["iterations"]


def test_plot_and_profile(tmp_path, capsys):
    png, prof = str(tmp_path / "h.png"), str(tmp_path / "prof")
    out = _port(["--config", "config1", "--ci", "--tol", "1e-4", "--plot",
                 png, "--profile", prof], capsys)
    assert out["converged"]
    assert os.path.getsize(png) > 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_row_layout_names_item_13(tmp_path, capsys):
    """``--mesh 2 --mesh-axis rows``, which refused before the row layout
    was ported (the name is kept): the port's row-sharded FISTA over 2
    gloo ranks against the JAX CLI's over 2 CPU devices, on config 1's CI
    size drawn by the host generator in both (``--polish`` makes the JAX
    CLI draw it so): the same lambda, both at or below tol (the f32 gap,
    or the polish's certificate), the same nnz, x within 5e-5 (the row
    FISTA's parity tolerance, ``tests/test_torch_row_sharded.py``)."""
    argv = ["--m", "128", "--n", "512", "--polish", "--tol", "1e-6",
            "--mesh", "2", "--mesh-axis", "rows"]
    snaps = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "port")}
    assert jax_main(argv + ["--checkpoint", snaps["jax"]]) == 0
    out_j = _last_json(capsys)
    out_p = _port(argv + ["--checkpoint", snaps["port"]], capsys)
    assert out_p["method"] == "row_sharded_fista" == out_j["method"]
    snap_j, snap_p = jax_load_snapshot(snaps["jax"]), \
        ckpt.load_snapshot(snaps["port"])
    assert snap_p.lam1 == pytest.approx(snap_j.lam1, rel=1e-6)
    for out in (out_j, out_p):
        assert out.get("certified_rel_gap", out["rel_gap"]) <= 1e-6
    assert out_p["nnz"] == out_j["nnz"]
    np.testing.assert_allclose(snap_p.x, snap_j.x, atol=5e-5)


@pytest.mark.parametrize("argv", [
    ["--config", "config3", "--ci", "--tol", "1e-5"],      # screening on
    ["--config", "config2", "--ci", "--lambda-path", "4", "--tol", "1e-4"],
])
def test_sharded_screening_and_paths_name_item_13(argv, tmp_path, capsys):
    """``--mesh 2`` with config 3 (which screens) and with
    ``--lambda-path``, which refused before the sharded screening and
    paths were ported (the name is kept): the sharded run's JSON against
    the single-device CLI's on the same instance, and their snapshots' x
    within 5e-5 (the sharded FISTA's parity tolerance,
    ``tests/test_torch_sharded.py``)."""
    snaps = [str(tmp_path / f"{k}.npz") for k in ("one", "mesh")]
    one = _port(argv + ["--checkpoint", snaps[0]], capsys)
    mesh = _port(argv + ["--mesh", "2", "--checkpoint", snaps[1]], capsys)
    tol = float(argv[-1])
    if "path" in one:
        assert len(mesh["path"]) == len(one["path"]) == 4
        for r1, rm in zip(one["path"], mesh["path"]):
            assert rm["lam1"] == pytest.approx(r1["lam1"], rel=1e-5)
            assert r1["rel_gap"] <= tol and rm["rel_gap"] <= tol
            assert rm["nnz"] == r1["nnz"]
    else:
        assert (one["method"], mesh["method"]) == ("fista", "sharded_fista")
        assert one["converged"] and mesh["converged"]
        assert mesh["nnz"] == one["nnz"]
    x1, xm = (ckpt.load_snapshot(s).x for s in snaps)
    np.testing.assert_allclose(xm, x1, atol=5e-5)


def test_no_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", "config1", "--ci"])


def test_f64_instance(capsys):
    out = _port(["--config", "config1", "--ci", "--f64", "--tol", "1e-9",
                 "--method", "bcd"], capsys)
    assert out["converged"] and out["rel_gap"] <= 1e-9

"""The port's span recorder (``convex_optimization_tpu_torch/utils/trace``)
on the CPU:

  * with recording off nothing is recorded and ``record_function`` is never
    entered, while every span still times its region (the walls of
    ``Result`` and ``PolishResult``);
  * under ``torch.profiler`` spans nest with the right parents, and each
    profiler start opens the next session, also when two follow each
    other with no span between them;
  * the exported Chrome trace holds each ``cot.`` span around the aten
    operators issued inside it (one clock);
  * ``solve`` (FISTA, ``bcd_pallas``'s plain route), ``lambda_path``
    (``fista``, ``bcd_batch``, whose gate passes on the CPU) and
    ``polish_support`` (l1 and group_l2) emit the spans of ``PERF.md``'s
    table, with one ``cot.sync`` in every ``cot.check`` and none per step;
  * ``PolishResult.gather_s`` is the sum of the gather spans and the
    stages fit in the polish's wall; ``cli --profile`` traces the polish.
"""

import collections
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.cli import main
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.utils import trace
from tests.torch_threads import worker_threads  # noqa: F401

CPU = [ProfilerActivity.CPU]
PATH_CFG = SolverConfig(tol=1e-6, max_iters=2000, gap_every=10,
                        stall_checks=10, block_size=128)
POLISH_STAGES = {"cot.polish.setup", "cot.polish.round",
                 "cot.polish.gather", "cot.polish.cd64",
                 "cot.polish.witness"}


@pytest.fixture(autouse=True)
def empty_record():
    trace.RECORDER.clear()
    yield
    trace.RECORDER.clear()


@pytest.fixture(scope="module")
def inst():
    inst, A, b = make_lasso_instance_host(3, 96, 384, device="cpu")
    return inst.problem


def recorded(fn):
    """Run ``fn`` under a CPU profiler; (its result, the session's spans,
    the profiler)."""
    with profile(activities=CPU) as prof:
        out = fn()
    return out, trace.RECORDER.records(trace.RECORDER.session), prof


def named(recs, name):
    return [r for r in recs if r["name"] == name]


def parent_name(recs, r):
    return None if r["parent"] is None else recs[r["parent"]]["name"]


def test_recording_off_records_nothing(inst, monkeypatch):
    entered = []
    monkeypatch.setattr(trace, "record_function",
                        lambda name: entered.append(name))
    res = cot.solve(inst, "fista", tol=1e-5, max_iters=3000)
    path = cot.lambda_path(inst, PATH_CFG, path_len=3)
    pr = cot.polish_support(inst, res.x, tol=1e-7)
    assert res.converged and path.sweeps > 0 and pr.rel_gap <= 1e-7
    assert trace.RECORDER.spans == [] and trace.RECORDER.dropped == 0
    assert entered == []
    assert res.wall_time_s > 0 and res.setup_time_s > 0
    assert pr.wall_time_s > 0 and pr.gather_s > 0


def test_spans_nest_and_each_profiler_start_is_a_session():
    first = trace.RECORDER.session
    with profile(activities=CPU):
        with trace.span("cot.a", k=1) as a:
            with trace.span("cot.b"):
                with trace.CpuSpan("cot.c") as c:
                    torch.ones(64).sum()
            with trace.span("cot.d"):
                pass
        a.set(k=2)
    # two sessions back to back, no span between them
    with profile(activities=CPU):
        pass
    with profile(activities=CPU):
        with trace.span("cot.e"):
            pass
    assert trace.RECORDER.session == first + 3
    recs = trace.RECORDER.records()
    assert [(r["name"], parent_name(recs, r), r["session"] - first)
            for r in recs] == [("cot.a", None, 1), ("cot.b", "cot.a", 1),
                               ("cot.c", "cot.b", 1), ("cot.d", "cot.a", 1),
                               ("cot.e", None, 3)]
    assert recs[0]["attrs"] == {"k": 2}
    assert c.cpu_s >= 0.0 and c.minflt >= 0
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    assert recs[0]["seconds"] >= recs[1]["seconds"] >= recs[2]["seconds"]
    assert len(trace.RECORDER.records(first + 1)) == 4


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace.RECORDER, "cap", 3)
    with profile(activities=CPU):
        for _ in range(5):
            with trace.span("cot.x"):
                pass
    assert len(trace.RECORDER.spans) == 3 and trace.RECORDER.dropped == 2


def test_chrome_trace_holds_the_spans_around_their_ops(inst, tmp_path):
    def run():
        with trace.span("cot.outer"):
            torch.ones(256).sum()
        res = cot.solve(inst, "bcd_pallas", tol=1e-5, max_iters=3000)
        cot.polish_support(inst, res.x, tol=1e-7)

    _, recs, prof = recorded(run)
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    events = [e for e in json.loads(out.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    assert {r["name"] for r in recs} <= names
    outer = next(e for e in events if e["name"] == "cot.outer")
    ops = [e for e in events if e["name"] == "aten::sum"
           and outer["ts"] <= e["ts"] <= outer["ts"] + outer["dur"]]
    assert ops and all(e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
                       for e in ops)
    check = next(e for e in events if e["name"] == "cot.check")
    inside = [e for e in events if e["name"].startswith("aten::")
              and check["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= check["ts"] + check["dur"]]
    assert inside


def _loop_checks(recs):
    """Per cot.loop: (its iterations, its checks, its steps spans), and
    that each check holds one sync."""
    out = []
    for i, r in enumerate(recs):
        if r["name"] != "cot.loop":
            continue
        kids = [c for c in recs if c["parent"] == i]
        checks = [c for c in kids if c["name"] == "cot.check"]
        steps = [c for c in kids if c["name"] == "cot.steps"]
        out.append((r["attrs"]["iterations"], len(checks), len(steps)))
    for i, r in enumerate(recs):
        if r["name"] == "cot.check":
            syncs = [c for c in recs if c["parent"] == i]
            assert [c["name"] for c in syncs] == ["cot.sync"]
    return out


ROUTES = {
    "solve-fista": lambda p: cot.solve(p, "fista", tol=1e-6,
                                       max_iters=3000, stall_checks=15),
    "solve-bcd_pallas": lambda p: cot.solve(p, "bcd_pallas", tol=1e-6,
                                            max_iters=3000,
                                            stall_checks=15),
    "path-fista": lambda p: cot.lambda_path(p, PATH_CFG, path_len=4),
    "path-bcd_batch": lambda p: cot.lambda_path(p, PATH_CFG, path_len=4,
                                                method="bcd_batch"),
}
EXPECTED = {
    "solve-fista": {"cot.solve": None, "cot.setup": "cot.solve",
                    "cot.loop": "cot.solve"},
    "solve-bcd_pallas": {"cot.solve": None, "cot.setup": "cot.solve",
                         "cot.loop": "cot.solve"},
    "path-fista": {"cot.lambda_path": None, "cot.setup": "cot.lambda_path",
                   "cot.point": "cot.lambda_path", "cot.loop": "cot.point"},
    "path-bcd_batch": {"cot.lambda_path": None,
                       "cot.setup": "cot.lambda_path",
                       "cot.loop": "cot.lambda_path",
                       "cot.confirm": "cot.lambda_path"},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_emit_the_table_spans(inst, route):
    res, recs, _ = recorded(lambda: ROUTES[route](inst))
    parents = {(r["name"], parent_name(recs, r)) for r in recs}
    for name, parent in EXPECTED[route].items():
        assert (name, parent) in parents, (route, name, sorted(parents))
    loop_spans = {"cot.steps", "cot.check", "cot.sync"}
    # the batched path's f64 confirmation may polish a point
    polish = POLISH_STAGES | {"cot.polish", "cot.polish.near"}
    names = {n for n, _ in parents}
    assert loop_spans <= names
    assert names - loop_spans - set(EXPECTED[route]) <= (
        polish if route == "path-bcd_batch" else set())
    loops = _loop_checks(recs)
    gap_every = PATH_CFG.gap_every
    for iters, checks, steps in loops:
        # one steps span per gap_every iterations, none per step; the
        # solvers check once before their first steps, the batched loop
        # after them
        assert iters == gap_every * steps
        assert checks == steps + (route != "path-bcd_batch")
    total = sum(it for it, _, _ in loops)
    if route.startswith("solve"):
        assert total == res.iterations
        assert res.wall_time_s == pytest.approx(
            named(recs, "cot.loop")[0]["seconds"])
        assert res.setup_time_s == pytest.approx(
            named(recs, "cot.setup")[0]["seconds"])
    else:
        assert total == res.sweeps
        assert named(recs, "cot.lambda_path")[0]["attrs"] == {
            "method": "bcd_batch" if "batch" in route else "fista",
            "points": 4}
        assert res.method_used == route.split("-")[1]


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
def test_polish_stages_and_gather_s(kind, capsys):
    kw = dict(penalty_kind=kind, ngroups=48) if kind == "group_l2" else {}
    inst, A, b = make_lasso_instance_host(9, 96, 384, device="cpu", **kw)
    p = inst.problem
    # a loose solve, so that the support grows over the rounds
    x = cot.solve(p, "fista", tol=1e-2, max_iters=3000).x
    pr, recs, _ = recorded(
        lambda: cot.polish_support(p, x, tol=1e-7, verbose=True))
    assert pr.rel_gap <= 1e-7
    names = collections.Counter(r["name"] for r in recs)
    assert POLISH_STAGES <= set(names)
    assert set(names) <= POLISH_STAGES | {"cot.polish", "cot.polish.near"}
    whole = named(recs, "cot.polish")[0]
    assert whole["parent"] is None
    assert whole["attrs"] == {"kept": pr.kept,
                              "rounds": names["cot.polish.round"]}
    assert pr.wall_time_s == pytest.approx(whole["seconds"])
    gathers = named(recs, "cot.polish.gather")
    assert pr.gather_s == pytest.approx(sum(r["seconds"] for r in gathers))
    assert all(r["attrs"]["bytes"] == 4 * 96 * r["attrs"]["columns"]
               for r in gathers)
    stages = sum(r["seconds"] for r in recs
                 if r["name"] in POLISH_STAGES - {"cot.polish.round"}
                 or r["name"] == "cot.polish.near")
    assert stages <= pr.wall_time_s
    for r in recs:
        if r["name"] in ("cot.polish.setup", "cot.polish.round"):
            assert parent_name(recs, r) == "cot.polish"
        elif r["name"] != "cot.polish":
            assert parent_name(recs, r) == "cot.polish.round"
    assert named(recs, "cot.polish.cd64")[-1]["attrs"]["sweeps"] \
        == pr.iterations
    err = capsys.readouterr().err
    for stage in ("setup", "gather(", "cd64(sweeps=", "witness"):
        assert f"polish[{stage}" in err
    assert "minflt +" in err


def test_cli_profile_traces_the_polish(tmp_path, capsys):
    # --max-iters 200: the f32 solve stops above 1e-7 and the polish runs
    prof = tmp_path / "prof"
    assert main(["--device", "cpu", "--m", "96", "--n", "384", "--tol",
                 "1e-7", "--max-iters", "200", "--polish", "--profile",
                 str(prof)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["certified"]
    assert "achieved_gb_s" not in out and "fraction_of_hbm_peak" not in out
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"cot.solve", "cot.loop", "cot.check", "cot.sync", "cot.polish",
            "cot.polish.gather", "cot.polish.cd64"} <= names

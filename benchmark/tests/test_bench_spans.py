"""The per-layer metrics that read the program's own spans
(``benchlib/spans.py``): a traced run of one small cert cell and one small
path cell on the CPU, past the look for a card, prints every one of them,
and they agree with the clocks around the same calls.

On a card the metrics read the request profiled on the device alone,
which records no host operator, so ``loop_ms_per_iter`` sits under
``ms_per_iter`` (the benchmark's clock around the entry, in the unprofiled
requests).  On the CPU every profiled request records each operator and
runs slower than the unprofiled ones, so here the loop is held to the
entry's own span in the same request."""

import dataclasses
import sys
import time

import pytest
import torch

import convex_optimization_tpu_torch as cot
from benchlib import cell_run, spans, spec

SPAN_METRICS = {
    "cert": ["loop_ms_per_iter.cert", "sync_wait_share.cert",
             "call_setup_s.cert", "polish_cd_s.cert",
             "polish_gather_s.cert"],
    "path": ["loop_ms_per_iter.path", "sync_wait_share.path",
             "call_setup_s.path"],
}
# small instances; the path's grid stops at 0.2 lam_max, so that its
# profiled requests stay short on the CPU
CUT = {"lasso-10kx100k": {"m": 300, "n": 1500},
       "lasso-5kx50k": {"m": 200, "n": 1000, "path_len": 4,
                        "lam_min_frac": 0.2}}
ENTRY = {"cert": "cot.solve", "path": "cot.lambda_path"}


def traced(name: str) -> tuple[dict, list]:
    """The metrics of a traced run, and the spans they read."""
    c = spec.find_cell(name)
    c = dataclasses.replace(c, config={**c.config,
                                       **CUT[c.config["name"]]},
                            traffic={**c.traffic, "instances": 1})
    res, _ = cell_run.run(cot, c, seed=2**33 + 5, seconds=0.5, trace=True,
                          device=torch.device("cpu"),
                          t_process=time.perf_counter())
    assert res["correct"], res["check"]
    return {k: v["value"] for k, v in res["metrics"].items()}, \
        spans.records()


@pytest.mark.parametrize("name,kind", [
    ("lasso-10kx100k.bcd-cert", "cert"),
    ("lasso-5kx50k.batch-path", "path"),
])
def test_span_metrics_are_printed_and_agree(name, kind):
    got, recs = traced(name)
    for metric in SPAN_METRICS[kind] + [f"ms_per_iter.{kind}"]:
        assert metric in got, (metric, sorted(got))
    assert 0.0 <= got[f"sync_wait_share.{kind}"] <= 100.0
    assert got[f"call_setup_s.{kind}"] > 0.0
    # one request, and the loop inside the entry's own clock
    assert spans.requests(recs, ENTRY[kind]) == 1
    iters = sum(r["attrs"]["iterations"] for r in recs
                if r["name"] == "cot.loop")
    assert iters == got[f"iters.{kind}"]
    entry_ms = 1e3 * spans.seconds(recs, ENTRY[kind]) / iters
    assert 0.0 < got[f"loop_ms_per_iter.{kind}"] <= entry_ms
    if kind == "cert":
        polish = spans.seconds(recs, "cot.polish")
        stages = got["polish_cd_s.cert"] + got["polish_gather_s.cert"]
        assert 0.0 < stages <= polish
        assert got["polish_s.cert"] > 0.0


def test_no_recorder_reads_nothing(monkeypatch):
    """A program without the recorder (an older commit): every reader
    returns None, so the harness leaves the metric out."""
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    for names in SPAN_METRICS.values():
        for metric in names:
            assert spec.metric_reader(metric).read(None) is None

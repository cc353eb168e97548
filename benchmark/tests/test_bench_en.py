"""Config 3's cell (``nonneg-en-10kx100k.screened-cert``) on the CPU, at
small sizes, with the cell's own settings and limits:

  * its data step gives the same bits twice and a nonnegative x*;
  * its reference's primal is ``tests/oracle.objective_np``'s, and its gap
    lies between 0 and the oracle's (the oracle scales the dual by
    1 / max(1, dual norm), a point of the range over which the reference
    maximises it); the reference itself imports nothing from ``tests/``;
  * the control (one precision down) comes out not correct;
  * a whole run past the look for a card is correct for the sound
    program, and not correct for a solve that ignores lam2, one run as
    the plain l1 (negative entries), and a keep mask that freezes a
    column of the support;
  * the cell resolves, and a traced run prints its kept share.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import convex_optimization_tpu_torch as cot
from benchlib import (cell_run, data, data_en, peaks, reference,
                      reference_en, spec)
from tests import oracle

CELL = "nonneg-en-10kx100k.screened-cert"
CFG = {"m": 60, "n": 300, "support_frac": 0.05, "noise_std": 0.01,
       "lam1_frac": 0.1, "lam2": 1e-3}
SEEDS = (2**33 + 1, 2**33 + 2, 2**33 + 3)
H100 = "NVIDIA H100 80GB HBM3"


def small(m=300, n=1500):
    c = spec.find_cell(CELL)
    return dataclasses.replace(c, config={**c.config, "m": m, "n": n},
                               traffic={**c.traffic, "instances": 1})


def run(cell, trace=False, seed=2**33 + 77):
    res, _ = cell_run.run(cot, cell, seed=seed, seconds=0.0, trace=trace,
                          device=torch.device("cpu"),
                          t_process=time.perf_counter())
    return res


def test_data_step_is_deterministic_and_nonnegative():
    inst = data.make_instance(data.instance_seed(5), CFG, "cpu")
    a, b = data_en.nonneg(inst, CFG), data_en.nonneg(inst, CFG)
    assert torch.equal(a.b, b.b) and a.lam1 == b.lam1
    assert a.A_rows is inst.A_rows and a.b.dtype == torch.float32
    assert float(a.x_true.min()) >= 1.0
    assert torch.equal(a.x_true, inst.x_true.abs())
    A = inst.A.numpy().astype(np.float64)
    x = np.zeros(CFG["n"])
    x[inst.support.numpy()] = inst.x_true.numpy()
    want = (inst.b.numpy().astype(np.float64)
            + A @ (np.abs(x) - x)).astype(np.float32)
    np.testing.assert_allclose(a.b.numpy(), want, rtol=0, atol=1e-6)
    lam_max = max((A.T @ a.b.numpy().astype(np.float64)).max(), 0.0)
    assert abs(a.lam_max - lam_max) <= 1e-12 * lam_max
    assert a.lam1 == CFG["lam1_frac"] * a.lam_max


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_against_the_oracle(seed, monkeypatch):
    monkeypatch.setattr(reference, "CHUNK", 64)      # several blocks
    inst = data_en.nonneg(data.make_instance(data.instance_seed(seed), CFG,
                                             "cpu"), CFG)
    A = inst.A.numpy().astype(np.float64)
    b = inst.b.numpy().astype(np.float64)
    lam1, lam2 = inst.lam1, CFG["lam2"]
    rng = np.random.default_rng(seed % 2**32)
    x_cd = reference_en.solve_cd(inst.A_rows, inst.b, lam1, lam2)
    for x in (np.where(rng.random(300) < 0.1, rng.random(300), 0.0),
              np.zeros(300), x_cd):
        P = reference_en.objective(inst.A_rows, inst.b, lam1, lam2, x)
        want = oracle.objective_np(A, b, x, lam1, lam2, "nonneg_l1")
        assert abs(P - want) <= 1e-12 * abs(want)
        gap = reference_en.rel_gap(inst.A_rows, inst.b, lam1, lam2, x)
        o_gap, o_primal = oracle.dual_gap_np(A, b, x, lam1, lam2,
                                             "nonneg_l1")
        assert -1e-15 <= gap <= o_gap / o_primal + 1e-15
    assert reference_en.rel_gap(inst.A_rows, inst.b, lam1, lam2,
                                x_cd) <= 1e-12
    assert reference_en.rel_gap(inst.A_rows, inst.b, lam1, lam2,
                                -x_cd) == np.inf
    # x = 0 solves it at lam_max and above, whatever lam2
    assert abs(reference_en.rel_gap(inst.A_rows, inst.b, inst.lam_max, lam2,
                                    np.zeros(300))) < 1e-12


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(seed):
    cell = small(400, 2000)
    job = spec.job_module(cell.kind)
    inst = data.make_instance(data.instance_seed(seed), cell.config, "cpu")
    out = job.control(inst, cell.config, cell.traffic)
    worst, ok, _ = cell_run.judge_all(job.judge, lambda i: inst, cell,
                                      [{**out, "instance": 0}])
    assert not ok, worst
    assert worst["neg"] == 0 and worst["screen_err"] == 0


def without_lam2(orig):
    def make_problem(A, b, lam1, **kw):
        return orig(A, b, lam1, **{**kw, "lam2": 0.0})
    return make_problem


def freezing_a_support_column(orig):
    """``solve`` whose returned keep mask also freezes a column that the
    solution holds."""
    def solve(*a, **kw):
        res = orig(*a, **kw)
        if res.keep_mask is None:
            return res
        keep = res.keep_mask.clone()
        keep[int(torch.nonzero(res.x).flatten()[0])] = False
        return dataclasses.replace(res, keep_mask=keep)
    return solve


def test_sound_run_and_faults(monkeypatch):
    cell = small()
    res = run(cell)
    assert res["correct"] is True, res["check"]
    assert res["check"]["neg"]["value"] == 0
    assert res["check"]["screen_err"]["value"] == 0
    faults = {"lam2": ("make_problem", without_lam2(cot.make_problem)),
              "l1": ("nonneg_l1", cot.l1),
              "mask": ("solve", freezing_a_support_column(cot.solve))}
    for name, (attr, fake) in faults.items():
        with monkeypatch.context() as mp:
            mp.setattr(cot, attr, fake)
            res = run(cell)
        assert res["correct"] is False, name
        key = {"lam2": "gap", "l1": "neg", "mask": "screen_err"}[name]
        assert res["check"][key]["value"] > res["check"][key]["limit"], name


def test_cell_resolves_and_traced_run_reads_the_kept_share():
    c = spec.find_cell(CELL)
    assert c.kind == "cert_en" and c.chips == 1
    assert c.traffic["solver"]["screen_every"] == 1
    assert c.config["penalty"] == "nonneg_l1" and c.config["reduced"] == []
    names = {m["name"] for m in c.per_layer}
    assert {"kept_share.en", "k1_kept_roofline.en", "iters.cert",
            "idle_share.cert"} <= names and "k1_roofline" not in names
    assert {m["name"] for m in c.end_to_end} == {"cert_s", "setup_s"}
    got = run(small(), trace=True)["metrics"]
    assert 0.0 < got["kept_share.en"]["value"] < 100.0
    # no device trace of K1 on the CPU
    assert "k1_kept_roofline.en" not in got


def test_kept_roofline_charges_only_kept_columns():
    big = spec.load_json(f"{spec.BENCH_DIR}/configs/nonneg-en-10kx100k.json")
    traffic = {"solver": {"block_size": 128}}
    k1, kept = spec.roofline("k1"), spec.roofline("k1_kept")
    assert kept.KERNELS == k1.KERNELS
    assert kept.work(big, traffic, big["n"]) == k1.work(big, traffic)
    full = peaks.bound_s(kept.work(big, traffic, big["n"]), H100)
    part = peaks.bound_s(kept.work(big, traffic, 0.25 * big["n"]), H100)
    assert 1e3 * full == pytest.approx(1.194, abs=5e-4)
    assert 0.25 < part / full < 0.26

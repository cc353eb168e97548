"""``chip_smoke.path_check``, the rule that holds a small sharded run on the
card to the CPU run of the same input, shown on the CPU to be no weaker
than the step-count rule it replaced (|card steps - CPU steps| <=
gap_every, with the polish's f64 certificate and support).

The runs are chip_smoke.py phase 10's small sharded runs (SHARD_SMALL, P
= 2 gloo ranks, psum consensus) on the plain versions: the BCD
(SHARD_BCD), l1 and weighted group_l2, and FISTA (SHARD_FISTA), l1.
Every card stand-in is held to the plain run of the same input:

  * rounding-only stand-ins, which round differently and take no other
    path, on b as given and with one entry of b one ulp up.  BCD: the
    plain slab sweep with the block gradient A_j^T r, or the residual
    update r + A_j dx, summed in f64 and rounded to f32.  FISTA: the
    gradient A^T r summed in f32 (the plain version sums it in f64, K3 in
    f32), or the residual A x - b summed in f64 and rounded.  Each must
    pass ``path_check``;
  * BCD mutants, each standing in for a faulty kernel, made inside the
    rank by replacing what ``parallel.sharded._slab_sweep`` returns:
    every block's step scaled by 0.8; the last block of rank 1 skipped in
    every sweep; the payload's <x, dx> set to 0 (on the instance with
    lam2 = MUTANT_LAM2: the line search weighs that term by lam2, so at
    lam2 = 0 the mutant is the plain run); rank 1's steps scaled by 0.8 (a
    path 14-18 % slower); every step scaled by 0.5 from the step at which
    the plain run of the same input first reads <= 10 tol (a fault that
    shows only in the last decade).  Each must fail the old rule or the
    certificate / support check (the mutant is detectable), and
    ``path_check`` too.  The same late fault at 0.6 moves the stop by two
    checks, which the old rule fails and ``path_check`` lets through; a
    rounding-only stand-in moves the stop as far, so there the old rule's
    verdict is rounding's.

One rank job per module runs every case; the tests read its results.
``pytest -s`` prints, per method, the largest primal difference, rel_gap
ratio, crossing shift, last-decade shift and step-count difference over
the stand-ins and the stand-ins the old rule fails; per plain run set,
the range of its last f32 reading and of its f64 gap before the polish;
then the mutants' numbers.
Synthetic trajectories cover each of ``path_check``'s rules one at a time.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from test_torch_sharded_ranks import run_cpu_ranks  # noqa: E402

#: b as given (-1) and b[i] one ulp up
BCD_NUDGES = (-1, 0, 1, 2, 3, 7)
FISTA_NUDGES = (-1, 2, 7)
#: what a stand-in sums in another precision
STAND_INS = ("gradient", "residual")
#: the mutants' instance with lam2 > 0 (mutant iii's term is lam2 <x, dx>)
MUTANT_LAM2 = 0.1
MUTANTS = ("step_0.8", "skip_last_block", "zero_xdx", "rank1_step_0.8",
           "late_0.5")
#: a late mutant whose slowdown is as large as rounding's
LATE_INSIDE = "late_0.6"
KINDS = ("l1", "group_l2")
KW = {"bcd_pallas": cs.SHARD_BCD, "fista": cs.SHARD_FISTA}


def _standin_sweep(f64, A_t, x, r, steps, keep, pen, lam2):
    """The plain slab sweep with the block gradient (``f64`` ==
    "gradient") or the residual update ("residual") summed in f64, then
    rounded to f32: another rounding, the same path."""
    from convex_optimization_tpu_torch.ops.bcd_sweep_slab import (
        merge_payload,
    )

    nb, B, m = A_t.shape
    n = nb * B
    rows = A_t.reshape(n, m)
    x_out, r_out = x.clone(), r.clone()
    for j in range(nb):
        sl = slice(j * B, (j + 1) * B)
        xj = x_out[sl]
        if f64 == "gradient":
            g = (rows[sl].double() @ r_out.double()).float()
        else:
            g = torch.mv(rows[sl], r_out)
        t = steps[j]
        xn = pen.prox_block(xj - t * (g + lam2 * xj), t, j, n)
        if keep is not None:
            xn = torch.where(keep[sl], xn, torch.zeros_like(xn))
        if f64 == "residual":
            r_out = (r_out.double()
                     + rows[sl].T.double() @ (xn - xj).double()).float()
        else:
            r_out += torch.mv(rows[sl].T, xn - xj)
        x_out[sl] = xn
    return x_out, r_out, merge_payload(x, x_out, r, r_out, pen)


def _fista_standin(f64):
    """``parallel.sharded``'s matvec name and its stand-in: the gradient
    -A^T r - lam2 x summed in f32, or A x - b summed in f64, rounded."""
    def neg_at_r(A_t, r, x, lam2):
        flat = A_t.reshape(-1, A_t.shape[2])
        return -torch.mv(flat, r) - lam2 * x

    def ax_minus_b(A_t, x, b):
        flat = A_t.reshape(-1, A_t.shape[2]).double()
        return (flat.T @ x.double() - b.double()).float()

    if f64 == "gradient":
        return "neg_at_r_t", neg_at_r
    return "ax_minus_b_t", ax_minus_b


def _mutant(name, rank, sweep, start):
    """``sweep`` with the fault ``name`` injected on this rank (``start``:
    the first step of a late mutant, late_<step scale>)."""
    calls = [0]

    def run(A_t, x, r, steps, keep, pen, lam2):
        calls[0] += 1
        if name == "step_0.8":
            return sweep(A_t, x, r, 0.8 * steps, keep, pen, lam2)
        if name == "rank1_step_0.8":
            return sweep(A_t, x, r, (0.8 if rank == 1 else 1.0) * steps,
                         keep, pen, lam2)
        if name.startswith("late_"):
            scale = float(name[5:]) if calls[0] > start else 1.0
            return sweep(A_t, x, r, scale * steps, keep, pen, lam2)
        if name == "skip_last_block":
            if rank == 1:       # t = 0: the block's x and r stay as they are
                steps = steps.clone()
                steps[-1] = 0.0
            return sweep(A_t, x, r, steps, keep, pen, lam2)
        if name == "zero_xdx":
            x_out, r_out, pay = sweep(A_t, x, r, steps, keep, pen, lam2)
            pay = pay.clone()
            pay[r.shape[0]] = 0.0
            return x_out, r_out, pay
        raise ValueError(name)
    return run


def _problem(A, b, pens, kind, nudge, lam2):
    """The CPU problem of one case, and its b (nudge >= 0: b[nudge] one ulp
    up)."""
    import convex_optimization_tpu_torch as cot

    b = b.copy()
    if nudge >= 0:
        b[nudge] = np.nextafter(b[nudge], np.float32(np.inf))
    return cot.problem_from_numpy(A, b, device="cpu", lam2=lam2,
                                  **pens[kind]), b


def path_job(g, A, b, pens, cases) -> dict:
    """Every case (name, method, kind, nudge, variant, lam2) as the smoke's
    small sharded run on this rank; returns per case the gathered x, the
    history and ``converged``.  A case's plain run comes before its
    mutants."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.parallel import sharded

    saved = {k: getattr(sharded, k)
             for k in ("_slab_sweep", "neg_at_r_t", "ax_minus_b_t")}
    out = {}
    try:
        for name, method, kind, nudge, variant, lam2 in cases:
            p, _ = _problem(A, b, pens, kind, nudge, lam2)
            kw = KW[method]
            if variant in STAND_INS and method == "fista":
                setattr(sharded, *_fista_standin(variant))
            elif variant in STAND_INS:
                sharded._slab_sweep = (
                    lambda loc, B, cfg, v=variant:
                    lambda *a: _standin_sweep(v, *a))
            elif variant != "plain":
                plain = out[("plain", method, kind, nudge)]
                start = kw["gap_every"] * cs.first_check_at(
                    plain["rel_gap"], cs.PATH_LEVELS[0] * kw["tol"])
                sharded._slab_sweep = (
                    lambda loc, B, cfg, v=variant, s=start:
                    _mutant(v, g.rank, saved["_slab_sweep"](loc, B, cfg),
                            s))
            try:
                res = cot.solve(p, method, mesh=g, consensus="psum", **kw)
            finally:
                for k, v in saved.items():
                    setattr(sharded, k, v)
            out[name] = dict(x=res.x.numpy(), k=res.iterations,
                             primal=res.history["primal"].tolist(),
                             rel_gap=res.history["rel_gap"].tolist(),
                             converged=bool(res.converged))
    finally:
        for k, v in saved.items():
            setattr(sharded, k, v)
    return out


def _cases():
    """(name, method, kind, nudge, variant, lam2); a mutant's reference is
    the plain run at nudge "lam2" (lam2 = MUTANT_LAM2) or -1."""
    cases = []
    for method, kinds, nudges in (("bcd_pallas", KINDS, BCD_NUDGES),
                                  ("fista", ("l1",), FISTA_NUDGES)):
        for kind in kinds:
            for nudge in nudges:
                cases.append((("plain", method, kind, nudge), method, kind,
                              nudge, "plain", 0.0))
                cases += [((v, method, kind, nudge), method, kind, nudge, v,
                           0.0) for v in STAND_INS]
    for kind in KINDS:
        cases.append((("plain", "bcd_pallas", kind, "lam2"), "bcd_pallas",
                      kind, -1, "plain", MUTANT_LAM2))
        for mutant in MUTANTS + (LATE_INSIDE,):
            lam2 = MUTANT_LAM2 if mutant == "zero_xdx" else 0.0
            ref = "lam2" if lam2 else -1
            cases.append(((mutant, "bcd_pallas", kind, ref), "bcd_pallas",
                          kind, -1, mutant, lam2))
    return cases


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    """Every stand-in and mutant run with the plain run of its input, each
    with what path_check reads (the polish to 1e-6, as the smoke polishes
    the small runs)."""
    A, b, pens = cs.shard_small_instance()
    cases = _cases()
    out = run_cpu_ranks(path_job, cs.SHARD_P, tmp_path_factory.mktemp("pc"),
                        A, b, pens, cases)[0]
    runs = {}
    for name, method, kind, nudge, _, lam2 in cases:
        p, bb = _problem(A, b, pens, kind, nudge, lam2)
        runs[name] = cs.path_run(p, out[name], A, bb, 1e-6)
    pairs = {}
    for name, method, kind, nudge, variant, lam2 in cases:
        if variant != "plain":
            pairs[name] = (runs[name], runs[("plain",) + name[1:]])
    _print_worst(pairs)
    return pairs


def _print_worst(pairs):
    """The stand-ins' largest distances from their plain runs, per method."""
    for method in KW:
        nums = [cs.path_numbers(*pair, KW[method]["tol"])
                for name, pair in pairs.items()
                if name[0] in STAND_INS and name[1] == method]
        print(json.dumps({
            "method": method, "stand_ins": len(nums),
            "primal_rel_diff": max(n["primal_rel_diff"] for n in nums),
            "rel_gap_ratio": max(n["rel_gap_ratio"] for n in nums),
            "crossing_shift": max(abs(s) for n in nums
                                  for s in n["crossing_shift"].values()),
            "last_decade_shift": max(abs(n["last_decade_shift"])
                                     for n in nums),
            "stop_shift": max(abs(c["k"] - h["k"]) for name, (c, h)
                              in pairs.items() if name[0] in STAND_INS
                              and name[1] == method),
            "old_rule_fails": [list(name) for name, (c, h) in pairs.items()
                               if name[0] in STAND_INS and name[1] == method
                               and _old_rule_fails(c, h, method)]}))
    plains = {}
    for name, (c, h) in pairs.items():
        if name[0] in STAND_INS:
            plains.setdefault(name[1:3], {})[name[3]] = h
    for (method, kind), runs in plains.items():
        print(json.dumps({
            "plain": [method, kind], "runs": len(runs),
            "f32_last": [min(r["rel_gap"][-1] for r in runs.values()),
                         max(r["rel_gap"][-1] for r in runs.values())],
            "f64_rel_gap": [min(r["f64_rel_gap"] for r in runs.values()),
                            max(r["f64_rel_gap"] for r in runs.values())]}))
    for name, (c, h) in pairs.items():
        if name[0] not in STAND_INS:
            print(json.dumps({"mutant": list(name), "steps": [c["k"], h["k"]],
                              "old_rule_fails": _old_rule_fails(c, h),
                              **cs.path_numbers(c, h, 1e-6),
                              "path_check": _check(c, h)}))


def _old_rule_fails(card, cpu, method="bcd_pallas") -> bool:
    """The rule path_check replaced: steps within one check, and after the
    polish an f64 gap <= 1e-6 with the CPU's support."""
    return (abs(card["k"] - cpu["k"]) > KW[method]["gap_every"]
            or not card["polished_rel_gap"] <= 1e-6
            or not bool((card["support"] == cpu["support"]).all()))


def _check(card, cpu, method="bcd_pallas"):
    return cs.path_check(card, cpu, KW[method]["tol"],
                         KW[method]["gap_every"])


def _stand_in_ids():
    return [(method, kind, v, nudge)
            for method, kinds, nudges in (("bcd_pallas", KINDS, BCD_NUDGES),
                                          ("fista", ("l1",), FISTA_NUDGES))
            for kind in kinds for v in STAND_INS for nudge in nudges]


@pytest.mark.parametrize("method,kind,stand_in,nudge", _stand_in_ids())
def test_rounding_only_stand_in_passes(held, method, kind, stand_in, nudge):
    card, cpu = held[(stand_in, method, kind, nudge)]
    assert _check(card, cpu, method) == [], cs.path_numbers(
        card, cpu, KW[method]["tol"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutant_is_caught_by_the_old_rule_and_by_path_check(held, mutant,
                                                            kind):
    ref = "lam2" if mutant == "zero_xdx" else -1
    card, cpu = held[(mutant, "bcd_pallas", kind, ref)]
    assert _old_rule_fails(card, cpu), (card["k"], cpu["k"])
    assert _check(card, cpu), cs.path_numbers(card, cpu, 1e-6)


def test_late_mutant_acts_only_in_the_last_decade(held):
    """The late mutant's path is the plain run's, bit for bit, until the
    plain run first reads <= 10 tol; only the last decade's length tells
    it apart."""
    for kind in KINDS:
        card, cpu = held[("late_0.5", "bcd_pallas", kind, -1)]
        i = cs.first_check_at(cpu["rel_gap"], 10 * 1e-6)
        assert card["primal"][:i + 1] == cpu["primal"][:i + 1]
        nums = cs.path_numbers(card, cpu, 1e-6)
        assert all(s == 0 for s in nums["crossing_shift"].values())
        assert nums["last_decade_shift"] > cs.PATH_LAST_DECADE
        assert any("last decade" in f for f in _check(card, cpu))


def test_a_late_mutant_path_check_lets_through_moves_the_stop_as_rounding(
        held):
    """Where path_check passes the late mutant at 0.6, its step count is no
    further from the plain run's than a rounding-only stand-in's is."""
    worst = max(abs(c["k"] - h["k"]) for name, (c, h) in held.items()
                if name[0] in STAND_INS and name[1] == "bcd_pallas")
    for kind in KINDS:
        card, cpu = held[(LATE_INSIDE, "bcd_pallas", kind, -1)]
        assert _check(card, cpu) or abs(card["k"] - cpu["k"]) <= worst, (
            card["k"], cpu["k"], worst)


TOL = 1e-6


def _synthetic(rel_gap, **kw):
    """A run whose f32 rel_gap falls by a factor of 2 per check from 1e-2
    (``rel_gap``: its readings), a smooth primal, converged, certified."""
    run = dict(primal=[1.0 + g for g in rel_gap], rel_gap=list(rel_gap),
               converged=rel_gap[-1] <= TOL, f64_rel_gap=0.5 * TOL,
               polished_rel_gap=0.5 * TOL, support=np.array([True, False]))
    run.update(kw)
    return run


def _halving(n=15, start=1e-2):
    return [start * 0.5 ** i for i in range(n)]


def test_identical_runs_pass():
    run = _synthetic(_halving())
    assert _check(run, dict(run)) == []


def test_one_check_shift_at_ten_tol_passes():
    cpu = _halving()                        # 1e-2 ... 6.1e-7
    level = 10 * TOL
    i = next(k for k, g in enumerate(cpu) if g <= level)
    card = list(cpu)
    card[i] = 1.02 * level                  # one check later at 10 tol
    assert cs.path_numbers(_synthetic(card), _synthetic(cpu),
                           TOL)["crossing_shift"]["1e-05"] == 1
    assert _check(_synthetic(card), _synthetic(cpu)) == []


def test_two_check_shift_fails():
    cpu = _halving()
    level = 10 * TOL
    i = next(k for k, g in enumerate(cpu) if g <= level)
    card = list(cpu)
    card[i] = card[i + 1] = 1.02 * level    # two checks later at 10 tol
    fails = _check(_synthetic(card), _synthetic(cpu))
    assert any("rel_gap <= 1e-05" in f for f in fails), fails


@pytest.mark.parametrize("extra", [2, 3])
def test_last_decade_is_held_to_two_checks(extra):
    """The same path to 10 tol, then ``extra`` more checks to the stop."""
    cpu = _halving()
    i = next(k for k, g in enumerate(cpu) if g <= 10 * TOL)
    card = cpu[:i + 1] + [cpu[i]] * extra + cpu[i + 1:]
    nums = cs.path_numbers(_synthetic(card), _synthetic(cpu), TOL)
    assert nums["last_decade_shift"] == extra
    fails = _check(_synthetic(card), _synthetic(cpu))
    assert (fails == []) == (extra <= cs.PATH_LAST_DECADE), fails


def test_primal_difference_of_2e_5_fails():
    cpu = _synthetic(_halving())
    card = dict(cpu, primal=list(cpu["primal"]))
    card["primal"][5] *= 1 + 2e-5
    assert any("primal" in f for f in _check(card, cpu))


def test_rel_gap_readings_a_factor_apart_fail():
    cpu = _synthetic(_halving())
    card = dict(cpu, rel_gap=list(cpu["rel_gap"]))
    card["rel_gap"][4] /= 2.5               # 6.3e-4: far above 10 tol
    assert any("factor" in f for f in _check(card, cpu))


def test_unconverged_run_fails():
    cpu = _synthetic(_halving())
    card = _synthetic(_halving(), converged=False)
    assert any("did not converge" in f for f in _check(card, cpu))
    stalled = _synthetic(_halving(14))      # ends at 1.2e-6 > tol
    assert any("did not converge" in f for f in _check(stalled, cpu))


def test_pre_polish_f64_gap_of_three_tol_fails():
    cpu = _synthetic(_halving())
    card = _synthetic(_halving(), f64_rel_gap=3 * TOL)
    assert any("before the polish" in f for f in _check(card, cpu))
    # where the CPU's own f64 gap is above tol, twice that is the limit
    assert _check(card, dict(cpu, f64_rel_gap=2 * TOL)) == []


def test_polish_and_support_are_kept():
    cpu = _synthetic(_halving())
    assert _check(_synthetic(_halving(), polished_rel_gap=2 * TOL), cpu)
    assert _check(_synthetic(_halving(), support=np.array([True, True])),
                  cpu)

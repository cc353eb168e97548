"""The port's dry run (``convex_optimization_tpu_torch/dryrun.py``) on the
CPU: ``dryrun_multichip(4)`` spawns 4 gloo ranks, each of which runs one
step of every sharded solver (the column layout in each consensus mode,
the group BCD, the batched path, the row layout, and the 2 x 2 grid),
and checks every rank's shapes and method names; ``entry()`` runs one
FISTA step.  The module, which spawned ranks import, imports no JAX."""

import os
import re

import convex_optimization_tpu_torch.dryrun as dryrun
from tests.torch_threads import worker_threads  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "convex_optimization_tpu_torch", "dryrun.py")


def test_dryrun_multichip_4_ranks():
    dryrun.dryrun_multichip(4, timeout_s=300.0)


def test_dryrun_expects_every_layout():
    assert {"rows_fista", "rows_bcd", "grid_fista", "grid_bcd", "ring",
            "reduce_scatter", "group", "batched_path"} <= set(
                dryrun.expected(4))
    assert "grid_fista" not in dryrun.expected(3)


def test_entry_runs_one_fista_step_on_the_cpu():
    fn, (problem, L_total, state) = dryrun.entry("cpu")
    out = fn(problem, L_total, state)
    assert out.k == 1 and out.x.shape == (1024,)
    assert L_total > 0 and bool(out.x.abs().sum() > 0)


def test_dryrun_imports_no_jax():
    src = open(SRC).read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"convex_optimization_tpu\.", src)

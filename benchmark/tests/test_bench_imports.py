"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the command refuses to run without a card or without the program."""

import ast
import os
import shutil
import subprocess
import sys

from benchlib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "convex_optimization_tpu", "bench",
             "chip_smoke"}


def test_no_source_imports_a_forbidden_module():
    for dirpath, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for name in names:
                    assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_a_run_loads_no_forbidden_module():
    """A whole cell run on the CPU in a fresh process, then the check that
    ``run.py`` makes once the window has closed."""
    code = f"""
import dataclasses, sys, time
sys.path[:0] = [{spec.BENCH_DIR!r}, {spec.ROOT!r}]
import torch, run
from benchlib import cell_run, spec
import convex_optimization_tpu_torch as cot
c = spec.find_cell("lasso-10kx100k.fista-cert")
c = dataclasses.replace(c, config={{**c.config, "m": 100, "n": 400}})
res, _ = cell_run.run(cot, c, seed=1, seconds=0.0, trace=True,
                      device=torch.device("cpu"),
                      t_process=time.perf_counter())
assert res["attempted"] >= 1
print("FOUND", run.forbidden_modules(), "program" in repr(cot))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] False" in out.stdout


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, spec.BENCH_DIR)
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["convex_optimization_tpu_torch_x"] = sys
        sys.modules["jaxfoo.bar"] = sys
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_refuses_without_card_or_program(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    args = ["--workload", "lasso-10kx100k.bcd-cert", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""
    # a directory that holds only BENCHMARK.json and the benchmark
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "run.import_program(); print('imported')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "imported" not in out.stdout

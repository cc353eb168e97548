"""The port's quickstart (``examples/quickstart_torch.py --small --device
cpu``) runs from a checkout in a subprocess of its own and certifies: the
solve converges and cross-validation picks a lambda.  One torch thread,
so the run stays near 10 s however many test workers share the cores."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_torch_small_runs_and_certifies():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
         "--small", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.join(REPO, "examples"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "converged=True" in out, out
    assert "path:" in out, out
    assert "cv:" in out and "best_lambda=" in out, out

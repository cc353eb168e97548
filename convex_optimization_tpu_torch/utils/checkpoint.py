"""Checkpoint / resume.

Counterpart of ``convex_optimization_tpu/utils/checkpoint.py``, with the
same ``np.savez`` keys (x, lam1, lam_index, iteration, meta as JSON bytes),
so a snapshot written by either package loads in the other.  The solver
state is the iterate and lam1: the residual is not saved but recomputed as
r = A x - b when the solve warm-starts.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch


class Snapshot(NamedTuple):
    x: np.ndarray           # (n,) iterate
    lam1: float             # current regularization
    lam_index: int          # position in the lambda path (-1: single solve)
    iteration: int          # iterations already spent at this lam1
    meta: dict              # free-form (config echo, problem sizes, seed)


def save_snapshot(path: str, x, lam1: float, *, lam_index: int = -1,
                  iteration: int = 0, meta: Optional[dict] = None) -> None:
    """Atomic snapshot write (a temporary file, then a rename); ``x`` a
    tensor on any device or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                x=x,
                lam1=np.float64(lam1),
                lam_index=np.int64(lam_index),
                iteration=np.int64(iteration),
                meta=np.frombuffer(
                    json.dumps(meta or {}).encode(), dtype=np.uint8),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_snapshot(path: str) -> Snapshot:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode() or "{}")
        return Snapshot(
            x=z["x"],
            lam1=float(z["lam1"]),
            lam_index=int(z["lam_index"]),
            iteration=int(z["iteration"]),
            meta=meta,
        )


def resume_solve(problem, path: str, **solve_kwargs):
    """Restore a snapshot and continue solving the same problem at the
    snapshot's lam1, warm-started on the problem's device.  Returns
    ``api.Result``."""
    from convex_optimization_tpu_torch.api import solve

    snap = load_snapshot(path)
    problem = problem.with_lam1(snap.lam1)
    x0 = torch.as_tensor(snap.x, dtype=problem.dtype, device=problem.device)
    return solve(problem, x0=x0, **solve_kwargs)

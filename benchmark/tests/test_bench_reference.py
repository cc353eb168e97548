"""The reference gap against an independent NumPy computation, and its
zeros."""

import numpy as np

from benchlib import data, reference

CFG = {"m": 80, "n": 400, "support_frac": 0.05, "noise_std": 0.01,
       "lam1_frac": 0.1}


def numpy_gap(A, b, lam, x):
    r = A @ x - b
    z = A.T @ r
    primal = 0.5 * r @ r + lam * np.abs(x).sum()
    alpha = min(max(-(r @ b) / (r @ r), 0.0), lam / np.abs(z).max())
    dual = alpha * -(r @ b) - 0.5 * alpha ** 2 * (r @ r)
    return (primal - dual) / primal


def cd_solve(A, b, lam, sweeps=3000):
    """Plain cyclic coordinate descent in f64 (unit columns)."""
    x = np.zeros(A.shape[1])
    r = -b.copy()
    for _ in range(sweeps):
        for j in range(A.shape[1]):
            g = A[:, j] @ r
            v = x[j] - g
            new = np.sign(v) * max(abs(v) - lam, 0.0)
            if new != x[j]:
                r += (new - x[j]) * A[:, j]
                x[j] = new
    return x


def test_gap_matches_numpy_and_vanishes_at_the_solution(monkeypatch):
    monkeypatch.setattr(reference, "CHUNK", 64)   # several blocks
    inst = data.make_instance(3, CFG, "cpu")
    A = inst.A.numpy().astype(np.float64)
    b = inst.b.numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    x = np.where(rng.random(400) < 0.1, rng.standard_normal(400), 0.0)
    g = reference.rel_gap(inst.A_rows, inst.b, inst.lam1, x)
    assert abs(g - numpy_gap(A, b, inst.lam1, x)) <= 1e-12 * max(1, g)
    xs = cd_solve(A, b, inst.lam1)
    assert 0 <= reference.rel_gap(inst.A_rows, inst.b, inst.lam1, xs) < 1e-9
    # x = 0 solves the lasso at lam_max and above
    assert abs(reference.rel_gap(inst.A_rows, inst.b, inst.lam_max,
                                 np.zeros(400))) < 1e-12
    assert reference.rel_gap(inst.A_rows, inst.b, inst.lam1,
                             np.zeros(400)) > 0.1
    assert abs(reference.lambda_max(inst.A_rows, inst.b)
               - np.abs(A.T @ b).max()) < 1e-9


def test_grid():
    g = reference.lambda_grid(2.0, 10, 0.01)
    assert len(g) == 10 and g[0] == 0.95 * 2.0
    assert abs(g[-1] - 0.02) < 1e-15 and np.all(np.diff(g) < 0)
    np.testing.assert_allclose(g[1:] / g[:-1], (0.01 / 0.95) ** (1 / 9))

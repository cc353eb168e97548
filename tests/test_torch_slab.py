"""K8 (the column-sharded slab sweep) and ``Penalty.value_diff`` in the port
against the JAX package on the same arrays.

K8's wrapper (K1's kernel with the payload, on the card) takes its plain
version on the CPU; it is held to the JAX
package's resident Pallas sweep ``bcd_sweep_pallas`` in interpret mode in
that kernel's own regime (m = 64, n = 1024, B = 256; tests/
test_pallas_sweep.py), at its tolerance rtol 1e-4 / atol 1e-5 (the TPU
kernel's MXU passes against f32 FMAs).  The epilogue is held to the JAX
package's merge expressions (parallel/sharded.py:370-382) evaluated in f64
on the port's own x and r: dr exactly, the three scalars to f32 rounding of
sums of n terms (1e-5 relative to the sum of magnitudes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.ops.bcd_sweep_pallas import (
    bcd_sweep_pallas,
    eligible,
)
from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import block_steps
from convex_optimization_tpu_torch.ops.bcd_sweep_slab import (
    merge_payload,
    sweep_slab_t,
    sweep_slab_t_plain,
)
from convex_optimization_tpu_torch.ops.matvec import block_power_t

M, N, B = 64, 1024, 256
CASES = [("l1", 0.0, 0), ("l1", 0.3, 0), ("nonneg_l1", 0.0, 0),
         ("group_l2", 0.0, 16)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _case(kind, lam2, ngroups, seed=0):
    """Unit-norm column-major A, b, the weights, lam1 at 0.1 lam_max and
    a start one ISTA step from 0 (as the JAX kernel's tests start)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, M)).astype(np.float32).T
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.standard_normal(M).astype(np.float32)
    w = None
    atb = np.abs(A.T @ b)
    if kind == "group_l2":
        w = rng.uniform(0.5, 2.0, ngroups).astype(np.float32)
        atb = np.linalg.norm((A.T @ b).reshape(ngroups, -1), axis=1) / w
    lam1 = 0.1 * float(atb.max())
    tp = problem_from_numpy(A, b, kind, lam1, lam2, ngroups, w, block=B,
                            device="cpu")
    jp = JProblem(A=jnp.asarray(A), b=jnp.asarray(b), lam2=lam2,
                  penalty=JPenalty(lam1=lam1, kind=kind, ngroups=ngroups,
                                   weights=None if w is None
                                   else jnp.asarray(w)))
    L = block_power_t(tp.A_t)
    t0 = 0.5 / float(L.max())
    x = tp.penalty.prox(t0 * torch.from_numpy(A.T @ b), t0)
    keep = rng.random(N) > 0.3
    return tp, jp, L, x, keep, w


@pytest.mark.parametrize("masked,step_scale", [(False, 1.0), (True, 0.5)])
@pytest.mark.parametrize("kind,lam2,ngroups", CASES)
def test_slab_sweep_plain_matches_jax_kernel(kind, lam2, ngroups, masked,
                                             step_scale):
    tp, jp, L, x, keep, w = _case(kind, lam2, ngroups)
    assert eligible(M, N, B)            # the JAX kernel, not its fallback
    r = tp.residual(x)
    keep_t = torch.from_numpy(keep) if masked else None
    xj, rj = bcd_sweep_pallas(
        jp, jnp.asarray(x.numpy()), jnp.asarray(r.numpy()),
        jnp.asarray(L.numpy()), step_scale=step_scale,
        keep_mask=jnp.asarray(keep) if masked else None, interpret=True)
    args = (tp.A_t, x, r, block_steps(L, lam2, step_scale), keep_t,
            tp.penalty, lam2)
    xt, rt, pay = sweep_slab_t(*args)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4,
                               atol=1e-5)
    assert float((xt - x).abs().max()) > 0          # the sweep moved x
    if masked:
        assert bool((xt[~keep_t] == 0).all())
    xp, rp, payp = sweep_slab_t_plain(*args)
    assert torch.equal(xt, xp) and torch.equal(pay, payp)

    # the epilogue against the JAX merge's expressions in f64
    x64, dx64 = x.double().numpy(), (xt - x).double().numpy()
    lam1 = float(tp.penalty.lam1)
    pen64 = JPenalty(lam1=lam1, kind=kind, ngroups=ngroups,
                     weights=None if w is None
                     else jnp.asarray(w.astype(np.float64)))
    want = [np.dot(x64, dx64), np.dot(dx64, dx64),
            float(pen64.value_diff(jnp.asarray(x64), jnp.asarray(dx64)))]
    # each value_diff term is at most lam1 w_g |dx| in size
    wmax = 1.0 if w is None else float(w.max())
    scale = [np.abs(x64 * dx64).sum(), np.dot(dx64, dx64),
             lam1 * wmax * np.abs(dx64).sum()]
    np.testing.assert_array_equal(pay[:M].numpy(), (rt - r).numpy())
    for got, want_k, s in zip(pay[M:].double().numpy(), want, scale):
        assert abs(got - want_k) <= 1e-5 * s, (got, want_k, s)


def test_payload_merges_the_ranks_like_the_jax_merge():
    """Two half-slabs' payloads, summed, give the JAX merge's lin, den and
    dG on the whole slab (the value_diff terms and the dots add over
    coordinates; dr over the halves' residual moves)."""
    tp, _, L, x, _, _ = _case("group_l2", 0.1, 16, seed=3)
    r = tp.residual(x)
    steps = block_steps(L, 0.1)
    half = N // 2
    pen_h = [Penalty(tp.penalty.lam1, "group_l2", 8,
                     tp.penalty.weights[h * 8:(h + 1) * 8]) for h in (0, 1)]
    outs = [sweep_slab_t(tp.A_t[2 * h:2 * h + 2], x[h * half:(h + 1) * half],
                         r, steps[2 * h:2 * h + 2], None, pen_h[h], 0.1)
            for h in (0, 1)]
    tot = outs[0][2] + outs[1][2]
    x_new = torch.cat([o[0] for o in outs])
    whole = merge_payload(x, x_new, r, r + tot[:M], tp.penalty)
    torch.testing.assert_close(tot[M:], whole[M:], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind,ngroups,weighted", [
    ("l1", 0, False), ("nonneg_l1", 0, False), ("group_l2", 8, False),
    ("group_l2", 8, True)])
def test_value_diff_matches_jax(kind, ngroups, weighted):
    rng = np.random.default_rng(ngroups + len(kind))
    x = np.where(rng.random(64) < 0.5, rng.standard_normal(64), 0.0)
    dx = np.where(rng.random(64) < 0.5, rng.standard_normal(64), 0.0)
    if kind == "nonneg_l1":
        x, dx = np.abs(x), np.abs(x + dx) - np.abs(x)
    w = rng.uniform(0.5, 2.0, ngroups) if weighted else None
    jp = JPenalty(lam1=0.3, kind=kind, ngroups=ngroups,
                  weights=None if w is None else jnp.asarray(w))
    tp = Penalty(lam1=0.3, kind=kind, ngroups=ngroups,
                 weights=None if w is None else torch.from_numpy(w))
    got = float(tp.value_diff(torch.from_numpy(x), torch.from_numpy(dx)))
    want = float(jp.value_diff(jnp.asarray(x), jnp.asarray(dx)))
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
    direct = float(tp.value(torch.from_numpy(x + dx))
                   - tp.value(torch.from_numpy(x)))
    assert abs(got - direct) <= 1e-10


def test_value_diff_has_no_cancellation_in_f32():
    """Near convergence g(x + dx) - g(x) is far below eps g(x): the
    difference of the two sums is noise, value_diff is not."""
    x = torch.full((4096,), 1.0, dtype=torch.float32)
    dx = torch.zeros_like(x)
    dx[7] = 1e-6
    pen = Penalty(lam1=1.0, kind="l1")
    assert float(pen.value_diff(x, dx)) == pytest.approx(1e-6, rel=1e-6)
    assert float(pen.value(x + dx) - pen.value(x)) != pytest.approx(
        1e-6, rel=1e-2)


def test_slab_sweep_counts_no_launch_on_cpu():
    tp, _, L, x, keep, _ = _case("l1", 0.0, 0)
    _build.reset_launches()
    sweep_slab_t(tp.A_t, x, tp.residual(x), block_steps(L, 0.0),
                 torch.from_numpy(keep), tp.penalty, 0.0)
    assert sum(_build.launches.values()) == 0
    with pytest.raises(ValueError):
        sweep_slab_t(torch.empty((2, 8, 16), device="meta"),
                     torch.empty(16, device="meta"),
                     torch.empty(16, device="meta"),
                     torch.empty(2, device="meta"), None, tp.penalty, 0.0)


def test_slab_route_takes_k9_where_the_tile_does_not_fit():
    """The sharded BCD's slab sweep on K1's fit rule, which K8 shares with
    K1 (one kernel, one plan): K8 where K1's tile fits (B = 80 at m =
    10000: K1's plan exists there), else K9 with the payload as tensor ops
    (B = 2000 at m = 20000: no plan), the same result on CPU tensors; the
    plain sweep without use_pallas."""
    import types

    from convex_optimization_tpu_torch.ops.bcd_sweep import (
        H100_SMS,
        sweep_route,
        sweep_tiling,
    )
    from convex_optimization_tpu_torch.parallel.sharded import _slab_sweep
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(use_pallas=True)
    cpu = torch.device("cpu")
    fits = types.SimpleNamespace(m=10_000, device=cpu)
    wide = types.SimpleNamespace(m=20_000, device=cpu)
    for B, m, route in ((80, 10_000, "k1"), (2000, 20_000, "k9")):
        assert sweep_route(B, m, H100_SMS) == route
        assert (sweep_tiling(B, m, H100_SMS) is not None) == (route == "k1")
    assert _slab_sweep(fits, 80, cfg) is sweep_slab_t
    assert _slab_sweep(fits, 80, SolverConfig()) is sweep_slab_t_plain
    k9 = _slab_sweep(wide, 2000, cfg)
    assert k9 not in (sweep_slab_t, sweep_slab_t_plain)
    tp, _, L, x, keep, _ = _case("group_l2", 0.1, 16)
    args = (tp.A_t, x, tp.residual(x), block_steps(L, 0.1),
            torch.from_numpy(keep), tp.penalty, 0.1)
    for got, want in zip(k9(*args), sweep_slab_t_plain(*args)):
        assert torch.equal(got, want)

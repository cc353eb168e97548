"""Nonsmooth penalty families with prox and dual norm.

Counterpart of ``convex_optimization_tpu/models/penalties.py``; the duality
conventions are documented there.  ``P(x) = 0.5||Ax - b||^2 + (lam2/2)||x||^2
+ g(x)`` with ``g`` one of:

  - ``"l1"``:        g(x) = lam1 * ||x||_1
  - ``"nonneg_l1"``: g(x) = lam1 * ||x||_1 + indicator(x >= 0)
  - ``"group_l2"``:  g(x) = lam1 * sum_g w_g ||x_g||_2 over contiguous,
                     equal-size groups

``value_diff`` serves the column-sharded BCD line search; ``screen_keep``
is the gap-safe sphere test of ``solvers/screening.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


def soft_threshold(v: torch.Tensor, t) -> torch.Tensor:
    """Elementwise soft-thresholding: prox of ``t * ||.||_1``."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


@dataclasses.dataclass(frozen=True)
class Penalty:
    """A nonsmooth penalty ``g``: ``kind`` as in the module docstring;
    ``lam1`` a float or 0-d tensor; ``weights`` None or an (ngroups,)
    tensor of positive group weights."""

    lam1: Scalar
    kind: str = "l1"
    ngroups: int = 0
    weights: Optional[torch.Tensor] = None

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.ngroups, -1)

    def _gweights(self, dtype, device=None) -> torch.Tensor:
        if self.weights is None:
            return torch.ones((self.ngroups,), dtype=dtype, device=device)
        return self.weights.to(dtype=dtype, device=device)

    def with_lam1(self, lam1) -> "Penalty":
        return dataclasses.replace(self, lam1=lam1)

    def value(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind in ("l1", "nonneg_l1"):
            return self.lam1 * torch.sum(torch.abs(x))
        if self.kind == "group_l2":
            gn = torch.linalg.vector_norm(self._grouped(x), dim=1)
            return self.lam1 * torch.sum(
                self._gweights(x.dtype, x.device) * gn)
        raise ValueError(f"unknown penalty kind {self.kind!r}")

    def value_diff(self, x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
        """g(x + dx) - g(x) without the difference of two large sums, which
        cancels in f32 near convergence (the sharded BCD line search).

        l1: |x + d| - |x| is sign(x) d exactly where the sign does not
        flip; elsewhere |x| <= |d|, so every term is O(|d_i|).  group_l2:
        ||a + d|| - ||a|| = (2<a, d> + ||d||^2) / (||a + d|| + ||a||)."""
        if self.kind in ("l1", "nonneg_l1"):
            xn = x + dx
            diff = torch.where(xn * x > 0, torch.sign(x) * dx,
                               torch.abs(xn) - torch.abs(x))
            return self.lam1 * torch.sum(diff)
        if self.kind == "group_l2":
            xg, dg = self._grouped(x), self._grouped(dx)
            n_old = torch.linalg.vector_norm(xg, dim=1)
            n_new = torch.linalg.vector_norm(xg + dg, dim=1)
            num = 2.0 * torch.sum(xg * dg, dim=1) + torch.sum(dg * dg, dim=1)
            diff = num / torch.clamp(n_new + n_old, min=1e-30)
            return self.lam1 * torch.sum(
                self._gweights(x.dtype, x.device) * diff)
        raise ValueError(f"unknown penalty kind {self.kind!r}")

    def prox(self, v: torch.Tensor, t) -> torch.Tensor:
        """argmin_u  t*g(u) + 0.5*||u - v||^2."""
        tl = t * self.lam1
        if self.kind == "l1":
            return soft_threshold(v, tl)
        if self.kind == "nonneg_l1":
            return torch.clamp(v - tl, min=0.0)
        if self.kind == "group_l2":
            vg = self._grouped(v)
            gn = torch.linalg.vector_norm(vg, dim=1, keepdim=True)
            w = self._gweights(v.dtype, v.device)[:, None]
            scale = torch.clamp(1.0 - tl * w / torch.clamp(gn, min=1e-30),
                                min=0.0)
            return (vg * scale).reshape(v.shape)
        raise ValueError(f"unknown penalty kind {self.kind!r}")

    def prox_block(self, v: torch.Tensor, t, block_idx: int,
                   n_total: int) -> torch.Tensor:
        """Prox restricted to contiguous column block ``block_idx`` of
        width ``v.shape[0]``; for group_l2 the block holds whole groups."""
        if self.kind in ("l1", "nonneg_l1"):
            return self.prox(v, t)
        if self.kind == "group_l2":
            gsize = n_total // self.ngroups
            gpb = v.shape[0] // gsize
            vg = v.reshape(gpb, gsize)
            w = self._gweights(v.dtype, v.device)[
                block_idx * gpb:(block_idx + 1) * gpb, None]
            gn = torch.linalg.vector_norm(vg, dim=1, keepdim=True)
            scale = torch.clamp(
                1.0 - t * self.lam1 * w / torch.clamp(gn, min=1e-30), min=0.0)
            return (vg * scale).reshape(v.shape)
        raise ValueError(f"unknown penalty kind {self.kind!r}")

    def dual_norm(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled so that dual feasibility reads ``dual_norm(z) <= 1``."""
        if self.kind == "l1":
            return torch.max(torch.abs(z)) / self.lam1
        if self.kind == "nonneg_l1":
            return torch.max(z) / self.lam1
        if self.kind == "group_l2":
            gn = torch.linalg.vector_norm(self._grouped(z), dim=1)
            return torch.max(gn / self._gweights(z.dtype, z.device)) \
                / self.lam1
        raise ValueError(f"unknown penalty kind {self.kind!r}")


    def screen_keep(self, z: torch.Tensor, alpha, gap, col_norms: torch.Tensor,
                    r_norm=0.0, primal=0.0) -> torch.Tensor:
        """Gap-safe sphere test: the (n,) bool keep mask.  ``keep == False``
        certifies x*_j = 0 at this lam1.

        z: the unscaled dual witness -A^T r - lam2 x; alpha the scaling
        that makes alpha * (-r) dual feasible and gap the duality gap at the
        same point; col_norms the augmented column norms sqrt(||A_j||^2 +
        lam2).  r_norm = ||r|| and primal = |P(x)| make the test safe under
        the working precision's rounding: the witness carries up to
        gamma ||A_j|| ||r|| of summation error and the gap O(gamma |P|),
        with gamma = 32 eps of z's dtype (every m <= 2^28)."""
        gamma = 32.0 * torch.finfo(z.dtype).eps
        gap_safe = gap + gamma * abs(primal)
        radius = torch.sqrt(torch.clamp(torch.as_tensor(
            2.0 * gap_safe, dtype=z.dtype, device=z.device), min=0.0))
        witness = alpha * z
        margin = alpha * gamma * col_norms * r_norm
        if self.kind == "l1":
            discard = (torch.abs(witness) + margin
                       + radius * col_norms < self.lam1)
        elif self.kind == "nonneg_l1":
            discard = witness + margin + radius * col_norms < self.lam1
        elif self.kind == "group_l2":
            gn = torch.linalg.vector_norm(self._grouped(witness), dim=1)
            # Frobenius bound on ||A~_g||_2 (>= its spectral norm): safe
            gcol = torch.sqrt(torch.sum(self._grouped(col_norms ** 2), dim=1))
            # ||z_g + dz_g|| <= ||z_g|| + gamma ||r|| gcol_g
            gmargin = alpha * gamma * r_norm * gcol
            w = self._gweights(z.dtype, z.device)
            gdiscard = gn + gmargin + radius * gcol < self.lam1 * w
            discard = torch.repeat_interleave(gdiscard,
                                              z.shape[0] // self.ngroups)
        else:
            raise ValueError(f"unknown penalty kind {self.kind!r}")
        return ~discard


def l1(lam1) -> Penalty:
    """Lasso penalty lam1*||x||_1 (elastic net = this + Problem.lam2 > 0)."""
    return Penalty(lam1=lam1, kind="l1")


def nonneg_l1(lam1) -> Penalty:
    """Nonnegative lasso penalty: lam1*||x||_1 restricted to x >= 0."""
    return Penalty(lam1=lam1, kind="nonneg_l1")


def group_l2(lam1, ngroups: int,
             weights: Optional[torch.Tensor] = None) -> Penalty:
    """Group lasso: lam1 * sum_g w_g ||x_g||_2 over contiguous equal groups."""
    if ngroups <= 0:
        raise ValueError("group_l2 requires ngroups > 0")
    return Penalty(lam1=lam1, kind="group_l2", ngroups=ngroups,
                   weights=weights)

"""Synthetic lasso data, drawn on the device.

The arithmetic of the repository's generator (a Gaussian A with unit
columns, a planted support of ``support_frac`` of the columns with values
z + sign(z), b = A x* + noise_std * noise, lam1 = lam1_frac * lam_max),
written here in plain PyTorch so that the program under test does not make
its own inputs.  A is drawn as G (n, m), rows contiguous, and used as the
column-major view A = G.T: the layout in which the program's transposed
``A_t`` needs no copy.  The draws come from one ``torch.Generator`` on the
device in four large calls; the same seed and sizes give the same numbers.

A cell's requests cycle through a fixed set of instances, drawn from the
configuration's ``data_seed`` (``instance_seeds``); the run's seed only
orders them.  So every run does the same work: fresh instances move it by
tens of per cent (iterations, and the rounds of the f64 polish), and so
does rounding, through the stall rule near the float32 floor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchlib import reference


@dataclasses.dataclass
class Draws:
    """The raw random numbers of one instance."""

    G: torch.Tensor          # (n, m) standard normal
    perm: torch.Tensor       # (n,) a permutation of the columns
    z: torch.Tensor          # (n,) standard normal: the first nnz are used
    noise: torch.Tensor      # (m,) standard normal


@dataclasses.dataclass
class Instance:
    A_rows: torch.Tensor     # (n, m) f32: row j is column j of A
    b: torch.Tensor          # (m,) f32
    support: torch.Tensor    # (nnz,) planted columns
    x_true: torch.Tensor     # (nnz,) their values
    lam_max: float           # max |A^T b|, in f64
    lam1: float              # lam1_frac * lam_max

    @property
    def A(self) -> torch.Tensor:
        return self.A_rows.T


def instance_seed(seed: int, k: int = 0) -> int:
    """A 63-bit seed for instance k of a run, from the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2**64, k]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def draw(seed: int, m: int, n: int, device) -> Draws:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    G = torch.randn((n, m), generator=g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    z = torch.randn((n,), generator=g, device=device)
    noise = torch.randn((m,), generator=g, device=device)
    return Draws(G=G, perm=perm, z=z, noise=noise)


def assemble(d: Draws, cfg: dict) -> Instance:
    """Turn the draws into an instance, in place on G."""
    G = d.G
    n, m = G.shape
    G /= torch.linalg.vector_norm(G, dim=1, keepdim=True)
    nnz = max(1, int(round(cfg["support_frac"] * n)))
    idx = d.perm[:nnz]
    z = d.z[:nnz]
    vals = z + torch.sign(z)
    b = torch.mv(G[idx].T, vals) + cfg["noise_std"] * d.noise
    lam_max = reference.lambda_max(G, b)
    return Instance(A_rows=G, b=b, support=idx, x_true=vals,
                    lam_max=lam_max, lam1=cfg["lam1_frac"] * lam_max)


def make_instance(seed: int, cfg: dict, device) -> Instance:
    return assemble(draw(seed, cfg["m"], cfg["n"], device), cfg)


def instance_seeds(cfg: dict, count: int) -> list:
    """The seeds of the configuration's first ``count`` instances."""
    return [instance_seed(cfg["data_seed"], i) for i in range(count)]


def order(seed: int, count: int) -> list:
    """The order in which a run takes the instances, from its seed."""
    rng = np.random.default_rng(instance_seed(seed))
    return [int(i) for i in rng.permutation(count)]

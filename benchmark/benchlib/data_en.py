"""Config 3's data: the lasso instance that ``data.py`` draws, turned into
the nonnegative elastic net's.

The repository's config-3 generator plants x* = |z + sign(z)| where the
lasso's plants v = z + sign(z), and sets lam1 from max(A^T b)_+.  So from
the lasso instance (A, b = A_S v + noise, v):

    b' = b + A_S (|v| - v)       summed in f64, rounded once to f32
    lam_max' = max(A^T b')_+     in f64
    lam1 = lam1_frac * lam_max'
    x* = |v|

A is the lasso's, untouched.  ``prepare`` and ``judge`` both call
``nonneg`` on the instance they were given, so they see the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from benchlib import reference_en
from benchlib.data import Instance


def nonneg(inst: Instance, config: dict) -> Instance:
    """The config-3 instance on the lasso instance's A (a new b, lam and
    x*; A shared)."""
    v = inst.x_true
    neg = torch.nonzero(v < 0).flatten()     # |v| - v = -2 v there, else 0
    b64 = inst.b.to(torch.float64)
    if neg.numel():
        cols = inst.A_rows[inst.support[neg]].to(torch.float64)
        b64 = b64 + cols.T @ (-2.0 * v[neg].to(torch.float64))
        del cols
    b = b64.to(torch.float32)
    lam_max = reference_en.lambda_max_nonneg(inst.A_rows, b)
    return dataclasses.replace(inst, b=b, x_true=v.abs(), lam_max=lam_max,
                               lam1=float(config["lam1_frac"]) * lam_max)

#!/usr/bin/env python3
"""K4 (`block_power_t`, the per-block power estimate ||A_j||_2^2) of one or
two source trees on the card, at the headline's A_t (1250 x 80 x 10 000),
config 2's (625 x 80 x 5000), one rank's slab of the headline at P = 2
(its blocks 625.., a view), and config 4's A (20 000 x 200 000) in blocks
of B = 200 (1000 x 200 x 20 000) and of B = 2000 (100 x 2000 x 20 000).

    python3 scripts/time_power.py [--root DIR] [--only SHAPE[,SHAPE]]

Imports `convex_optimization_tpu_torch` from this checkout and, with
--root, from DIR too (each builds its own kernels under its own build/),
and `chip_smoke.py` from this checkout.  Each A_t is allocated once (config
4's two widths are views of one 16 GB array) and runs through the trees in
the order DIR, this checkout, this checkout, DIR.  A_t is random (a seeded
device generator, rows of unit norm).  Each run checks the kernel against
the plain version (1e-4 relative per block), requires two launches to give
the same bits, and times it with CUDA events; each JSON line carries ms,
the plain version's ms, `torch.bmm(A_t, A_t.mT)`'s ms (the Gram alone, the
yardstick of K4's first phase), the bound of the Gram design's work and of
the first design's (`chip_smoke.power_work`), each CUDA kernel's mean
device time per call from `torch.profiler`, K4's plan where the tree has
`power_tiling`, and the card's name and power limit.  A first line per
tree gives the seconds of compiling csrc/matvec.cu alone.  Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
PKG = "convex_optimization_tpu_torch"
#: name -> (the array it views: its shape, blocks it starts at, its shape)
SHAPES = {
    "headline": ((1250, 80, 10_000), 0, (1250, 80, 10_000)),
    "slab": ((1250, 80, 10_000), 625, (625, 80, 10_000)),
    "config2": ((625, 80, 5000), 0, (625, 80, 5000)),
    "config4_b200": ((100, 2000, 20_000), 0, (1000, 200, 20_000)),
    "config4_b2000": ((100, 2000, 20_000), 0, (100, 2000, 20_000)),
}


def load_tree(root: str) -> dict:
    """The K4 wrapper of the tree at ``root``, its kernels built; modules
    of another tree already imported are dropped from sys.modules first
    (their functions keep their own modules)."""
    for name in list(sys.modules):
        if name == PKG or name.startswith(PKG + "."):
            del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from convex_optimization_tpu_torch.ops import _build
        from convex_optimization_tpu_torch.ops import matvec as mv
    finally:
        sys.path.remove(root)
    if not mv.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {mv.__file__}, not from {root}")
    _build.load()
    return {"root": root, "mv": mv, "build": _build,
            "build_s": _build.build_seconds}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--only", default=",".join(SHAPES))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_power: needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this checkout's, whatever --root is
    from time_matvec import trace_us
    from time_sweep_batch import compile_seconds

    gpu, power = [s.strip() for s in cs.card_line().split(",", 1)]
    here = load_tree(HERE)
    trees = [here]
    if args.root:
        other = load_tree(os.path.abspath(args.root))
        trees = [other, here, here, other]
    for t in {id(t): t for t in trees}.values():
        print(json.dumps({"root": t["root"], "source": "matvec.cu",
                          "compile_s": compile_seconds(t["build"],
                                                       "matvec.cu"),
                          "library_build_s": t["build_s"], "gpu": gpu,
                          "power_limit": power}), flush=True)
    dev = torch.device("cuda", 0)
    base_shape, base = None, None
    for name in args.only.split(","):
        src, start, shape = SHAPES[name]
        if src != base_shape:
            base = None
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(src[0])
            base = torch.randn(*src, generator=gen, device=dev)
            base /= torch.linalg.vector_norm(base, dim=2, keepdim=True)
            base_shape = src
        nb, B, m = shape
        flat = base.view(-1, m)[start * B:]
        A_t = flat[:nb * B].view(nb, B, m)
        plain = here["mv"].block_power_t_plain(A_t)
        common = {
            "plain_ms": cs.time_ms(
                lambda: here["mv"].block_power_t_plain(A_t), 1),
            "bmm_ms": cs.time_ms(lambda: torch.bmm(A_t, A_t.mT), 1),
            "bound_ms": cs.bound_ms(cs.power_work(nb, B, m)["gram"]),
            "first_design_bound_ms": cs.bound_ms(
                cs.power_work(nb, B, m)["first_design"])}
        for t in trees:
            print(json.dumps(run(cs, trace_us, t, A_t, plain) | common | {
                "root": t["root"], "shape": name, "A_t": list(shape),
                "gpu": gpu, "power_limit": power}), flush=True)
        del A_t, flat, plain


def run(cs, trace_us, tree: dict, A_t, plain) -> dict:
    import torch

    mv = tree["mv"]
    est = mv.block_power_t(A_t)
    rel = float(((est - plain).abs() / plain.abs().clamp(min=1e-30)).max())
    cs.require(rel <= 1e-4, f"{tree['root']}: K4 off by {rel} relative")
    same = torch.equal(est, mv.block_power_t(A_t))
    cs.require(same, f"{tree['root']}: K4 differs run to run")
    once = cs.time_ms(lambda: mv.block_power_t(A_t), 1)
    reps = max(1, min(20, int(2000 / max(once, 1e-3))))
    out = {"ms": cs.time_ms(lambda: mv.block_power_t(A_t), reps),
           "reps": reps, "max_rel_err": rel, "two_launches_equal": same,
           "kernels_us": trace_us(lambda: mv.block_power_t(A_t),
                                  calls=min(reps, 3))}
    if hasattr(mv, "power_tiling"):
        nb, B, m = A_t.shape
        sms = torch.cuda.get_device_properties(
            A_t.device).multi_processor_count
        out["plan"] = dataclasses.asdict(mv.power_tiling(nb, B, m, sms))
    return out


if __name__ == "__main__":
    main()

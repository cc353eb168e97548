#!/usr/bin/env python3
"""K1 (`sweep_t`, the single-lambda BCD sweep), K8 (`sweep_slab_t`, its
slab twin with the merge payload) and K9 (`sweep_tiled_t`, the streamed
sweep for blocks K1's tile cannot hold) of one source tree on the card: K1 on the
headline's A_t (1250 x 80 x 10 000, l1) with an all-ones keep mask as the
main path passes it and with config 3's keep mask (nonneg_l1, 17 % of the
columns kept, as config 3's last check leaves them), K1 and K8 on config
4's group tile (1000 x 200 x 20 000, group_l2 over groups of 200 with
weights), and K8 and K1 on one rank's slab of the headline (625 x 80 x
10 000) and where n >> m (the small sharded instance's slab width, B =
200 at m = 500, l1 and group_l2; K1 also at B = 40, m = 200); K9 at
config 4's K9 route (100 x 2000 x 20 000, group_l2 over groups of 200 with
weights, and l1) and at the tall shape (250 x 80 x 100 000, l1, the
all-ones mask; and at m = 100 003, K9's scalar instance).

    python3 scripts/time_sweep.py [--root DIR] [--only SETTING[,SETTING]]

Imports `convex_optimization_tpu_torch` from DIR (default: this checkout)
and `chip_smoke.py` from this checkout, so that two trees (a commit and its
parent unpacked beside it) run the same measurement in turn on one card.
A_t is random (a seeded device generator, columns of unit norm), b too;
each setting sweeps once from the plain version's first sweep from x = 0,
r = -b at 0.1 lam_max (so x and dx are both nonzero), checks the kernel
against its plain version (x and r to 1e-4, relative: 1000 or more
dependent blocks; K8's payload dr to 1e-4 of ||r|| and its three scalars
to 1e-4 of their magnitude sums), requires two launches to give the same
bits, and times it with CUDA events over REPS launches.  Each JSON line
carries ms per sweep, us per block, the bound (bytes at 3.35 TB/s or f32
operations at 67 TFLOP/s), the plain version's ms, each CUDA kernel's mean
device time per call from `torch.profiler`, K1's plan (on a tree that has
`bcd_sweep.sweep_plan`) or K9's (on a tree that has
`bcd_sweep_tiled.tiled_plan` returning a plan), K9's time to read A twice
and its plan's design bound (both from `chip_smoke.k9_bounds`), a digest of
the kernel's x and r (`bits`: the same on two trees means the same bits),
and the card's name and power limit; the slab's
K8 line says whether K1 gives K8's bits of x and r there.  A first line
gives the seconds of compiling csrc/sweep.cu alone.  Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
REPS = 10
HEADLINE = (1250, 80, 10_000)
C4 = (1000, 200, 20_000)
#: n >> m: the sharded small instance's slab width (B = 200, m = 500) and
#: the small reference solve's (B = 40, m = 200), over many blocks
SMALL_M = (500, 200, 500)
SMALL_M200 = (2500, 40, 200)
#: K9's shapes: config 4 at B = 2000 (block_size=3200) and the tall shape,
#: whose 32 MB blocks fit the L2 and whose slab the ring mostly keeps
C4_K9 = (100, 2000, 20_000)
TALL = (250, 80, 100_000)
TALL_RAGGED = (250, 80, 100_003)     # m % 4 != 0: K9's scalar instance
C4_GSIZE = 200
#: config 3's last check screens 82 890 of 100 000 columns (PERF.md §5)
C3_KEPT = 1 - 82_890 / 100_000
#: name -> (A_t shape, blocks taken from its start, penalty, keep mask,
#: kernel)
SETTINGS = {
    "headline": (HEADLINE, 1250, "l1", "ones", "sweep_t"),
    "config3_mask": (HEADLINE, 1250, "nonneg_l1", "config3", "sweep_t"),
    "config4_group": (C4, 1000, "group_l2", None, "sweep_t"),
    "config4_group_k8": (C4, 1000, "group_l2", None, "sweep_slab_t"),
    "slab_k8": (HEADLINE, 625, "l1", None, "sweep_slab_t"),
    "slab_k1": (HEADLINE, 625, "l1", None, "sweep_t"),
    "small_m": (SMALL_M, 500, "l1", None, "sweep_t"),
    "small_m_k8": (SMALL_M, 500, "l1", None, "sweep_slab_t"),
    "small_m_group": (SMALL_M, 500, "group_l2", None, "sweep_t"),
    "small_m_group_k8": (SMALL_M, 500, "group_l2", None, "sweep_slab_t"),
    "small_m200": (SMALL_M200, 2500, "l1", None, "sweep_t"),
    "config4_k9_group": (C4_K9, 100, "group_l2", None, "sweep_tiled_t"),
    "config4_k9_l1": (C4_K9, 100, "l1", None, "sweep_tiled_t"),
    "tall_k9": (TALL, 250, "l1", "ones", "sweep_tiled_t"),
    "tall_k9_ragged": (TALL_RAGGED, 250, "l1", "ones", "sweep_tiled_t"),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default=",".join(SETTINGS))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_sweep: needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this checkout's, whatever --root is
    from time_matvec import trace_us
    from time_sweep_batch import compile_seconds

    sys.path.insert(0, root)
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build

    if not cot.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {cot.__file__}, not from {root}")
    gpu, power = [s.strip() for s in cs.card_line().split(",", 1)]
    _build.load()
    build_s = _build.build_seconds
    print(json.dumps({"root": root, "source": "sweep.cu",
                      "compile_s": compile_seconds(_build, "sweep.cu"),
                      "library_build_s": build_s, "gpu": gpu,
                      "power_limit": power}), flush=True)
    dev = torch.device("cuda", 0)
    data: dict = {}
    for name in args.only.split(","):
        shape, blocks, kind, keep, kernel = SETTINGS[name]
        if shape not in data:
            data.clear()
            torch.cuda.empty_cache()
            data[shape] = make_data(shape, dev)
        out = run_setting(cs, trace_us, data[shape], blocks, kind, keep,
                          kernel)
        out.update({"root": root, "setting": name, "kernel": kernel,
                    "A_t": [blocks, *shape[1:]], "build_s": build_s,
                    "gpu": gpu, "power_limit": power})
        print(json.dumps(out), flush=True)


def make_data(shape, dev) -> dict:
    import torch

    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = shape
    n = nb * B
    gen = torch.Generator(device=dev).manual_seed(nb)
    A_t = torch.randn(nb, B, m, generator=gen, device=dev)
    A_t /= torch.linalg.vector_norm(A_t, dim=2, keepdim=True)
    b = torch.randn(m, generator=gen, device=dev)
    z = mv.neg_at_r_t_plain(A_t, b, torch.zeros(n, device=dev), 0.0)
    d = {"A_t": A_t, "b": b, "lmax": float(z.abs().max()),
         "steps": k1.block_steps(mv.block_power_t_plain(A_t), 0.0)}
    if B % C4_GSIZE == 0:
        ng = n // C4_GSIZE
        d["w"] = 0.5 + torch.rand(ng, generator=gen, device=dev)
        d["glmax"] = float((torch.linalg.vector_norm(
            z.view(ng, C4_GSIZE), dim=1) / d["w"]).max())
    cpu = torch.Generator(device="cpu").manual_seed(nb + 1)
    d["config3"] = (torch.rand(n, generator=cpu) < C3_KEPT).to(dev)
    d["ones"] = torch.ones(n, dtype=torch.bool, device=dev)
    return d


def run_setting(cs, trace_us, d: dict, blocks: int, kind: str, keep,
                kernel: str) -> dict:
    import torch

    from convex_optimization_tpu_torch.models.penalties import Penalty
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_slab as k8
    from convex_optimization_tpu_torch.ops import bcd_sweep_tiled as k9

    A_t = d["A_t"][:blocks]
    nb, B, m = A_t.shape
    n, b = nb * B, d["b"]
    steps = d["steps"][:blocks]
    if kind == "group_l2":
        ng = n // C4_GSIZE
        pen = Penalty(0.1 * d["glmax"], kind=kind, ngroups=ng,
                      weights=d["w"][:ng])
    else:
        pen = Penalty(0.1 * d["lmax"], kind=kind)
    mask = None if keep is None else d[keep][:n]
    x0, r0 = k1.sweep_t_plain(A_t, torch.zeros(n, device=A_t.device), -b,
                              steps, mask, pen, 0.0)
    args = (A_t, x0, r0, steps, mask, pen, 0.0)
    tol = 1e-4
    fn, plain = {"sweep_t": (k1.sweep_t, k1.sweep_t_plain),
                 "sweep_slab_t": (k8.sweep_slab_t, k8.sweep_slab_t_plain),
                 "sweep_tiled_t": (k9.sweep_tiled_t,
                                   k9.sweep_tiled_t_plain)}[kernel]
    out_k, out_r = fn(*args), fn(*args)
    if not all(torch.equal(a, c) for a, c in zip(out_k, out_r)):
        raise SystemExit(f"time_sweep: {kernel}: two launches differ")
    out_p = plain(*args)
    err = cs.sweep_err("time_sweep", kernel, out_k[0], out_k[1], out_p[0],
                       out_p[1], tol)
    if float((out_p[0] - x0).abs().max()) == 0:
        raise SystemExit("time_sweep: the sweep did not move x")
    # the bits of x and r, so two trees' lines show a bit-for-bit match
    line: dict = {"bits": hashlib.sha256(
        out_k[0].cpu().numpy().tobytes()
        + out_k[1].cpu().numpy().tobytes()).hexdigest()[:16]}
    work = cs.sweep_work(m, n, nb)
    if kernel == "sweep_slab_t":
        pk, pp = out_k[2], out_p[2]
        rn = float(torch.linalg.vector_norm(out_p[1]))
        cs.require(float(torch.linalg.vector_norm(pk[:m] - pp[:m]))
                   <= tol * rn, "time_sweep: K8 payload dr")
        dx = out_k[0] - x0
        scale = torch.stack([(x0 * dx).abs().sum(), (dx * dx).sum(),
                             float(pen.lam1) * dx.abs().sum()])
        es = (pk[m:] - k8.merge_payload(x0, out_k[0], r0, out_k[1],
                                        pen)[m:]).abs()
        cs.require(bool((es <= 1e-4 * scale).all()),
                   f"time_sweep: K8 payload scalars err {es.tolist()}")
        err = max(err, float((pk[:m] - pp[:m]).abs().max()))
        x1, r1 = k1.sweep_t(*args)
        line["k1_bits_equal"] = bool(torch.equal(x1, out_k[0])
                                     and torch.equal(r1, out_k[1]))
        work = cs.slab_work(m, n, nb)
    elif kind == "group_l2":
        work = (work[0] + 4 * (n // C4_GSIZE), work[1])
    ms = cs.time_ms(lambda: fn(*args), REPS)
    st: dict = {}
    cs.record(st, kernel, err, ms, cs.time_ms(lambda: plain(*args), 1),
              None, work)
    line.update({"penalty": kind, "keep": keep, "ms": ms,
                 "us_per_block": 1e3 * ms / nb,
                 "bound_ms": st[kernel]["bound_ms"],
                 "bound_by": st[kernel]["bound_by"],
                 "plain_ms": st[kernel]["plain_ms"], "max_abs_err": err,
                 "trace_us": trace_us(lambda: fn(*args), 5)})
    if kernel == "sweep_t" and hasattr(k1, "sweep_plan"):
        plan = k1.sweep_plan(A_t.device, B, m)
        line["plan"] = dataclasses.asdict(plan) | {
            "smem_bytes": plan.smem_bytes}
    if kernel == "sweep_tiled_t":
        plan = k9.tiled_plan(A_t.device, B, m)
        if dataclasses.is_dataclass(plan):      # the first design's is not
            line["plan"] = dataclasses.asdict(plan) | {
                "n_chunks": plan.n_chunks, "smem_bytes": plan.smem_bytes}
        bounds = cs.k9_bounds(m, n, nb, line.get("plan"),
                              work[0] - cs.sweep_work(m, n, nb)[0])
        line |= {k: v for k, v in bounds.items() if k != "bound_ms"}
    return line


if __name__ == "__main__":
    main()

"""Read the numbers that decide ``correct``, seed by seed, for setting a
cell's limits: the program's (one request a seed, as the window runs it)
or, with ``--control``, the control's (``benchlib/control.py``).  Each seed
draws a fresh instance, not one of the set that the cell's runs cycle
through, so the readings cover more than the runs do.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control]

One JSON line a seed on stdout: the judged numbers (for a path, each
point's f64 gap too), the seconds the request took and its iterations.
The benchmark's own runs never run this; it needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)


def readings(cot, cell, seeds: list, control: bool, device) -> list:
    import torch

    from benchlib import control as control_mod
    from benchlib import data, spec

    job_mod = spec.job_module(cell.kind)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    out = []
    for seed in seeds:
        inst = data.make_instance(data.instance_seed(seed), cell.config,
                                  device)
        sync()
        t0 = time.perf_counter()
        if control:
            o = getattr(control_mod, cell.kind)(inst, cell.config,
                                               cell.traffic)
            spans = {}
        else:
            job = job_mod.Job(cot, cell, device)
            job.prepare([inst])
            spans = job.request(time.perf_counter, 0)
            o = job.outputs[0]
            job.free()
        sync()
        secs = time.perf_counter() - t0
        nums = job_mod.judge(inst, cell.config, cell.traffic, o)
        if "xs" in o:
            from benchlib import reference

            lams = reference.lambda_grid(inst.lam_max,
                                         int(cell.config["path_len"]),
                                         float(cell.config["lam_min_frac"]))
            nums["point_gaps"] = [
                reference.rel_gap(inst.A_rows, inst.b, float(lam), x)
                for lam, x in zip(lams, o["xs"])]
            nums["point_conv"] = [bool(c) for c in o["converged"]]
        out.append({"workload": cell.name, "seed": seed,
                    "control": control, "seconds": secs, **spans, **nums})
        del inst
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(BENCH_DIR))
    import torch

    import convex_optimization_tpu_torch as cot
    from benchlib import spec

    cell = spec.find_cell(args.workload)
    device = torch.device("cuda")
    cot.ops._build.load()
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(cot, cell, seeds, args.control, device):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

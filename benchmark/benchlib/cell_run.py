"""One run of one cell: set-up, the window, the check, the result line.

Kept apart from ``run.py``'s look for a card, so that the tests can drive
a whole run on the CPU with the program's plain kernels underneath.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time

from benchlib import data, spec, trace as trace_mod, window as window_mod


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read."""

    cell: spec.Cell
    spans: list                 # per request (the profiled ones left out)
    trace: trace_mod.TraceSummary | None
    device_name: str


def judge_all(judge, insts, cell: spec.Cell, outputs: list) -> tuple:
    """Every request's numbers that the cell holds to a limit, the worst
    of each, whether each stays within its limit (a limit on a number the
    judge does not give fails), and how many requests failed.
    ``insts(i)`` gives instance i, drawn again."""
    per = []
    for i in sorted({o["instance"] for o in outputs}):
        inst = insts(i)
        per += [judge(inst, cell.config, cell.traffic, o)
                for o in outputs if o["instance"] == i]
        del inst
    worst = {k: max((nums.get(k, float("inf")) for nums in per),
                    default=float("inf")) for k in cell.limits}
    within = [all(nums.get(k, float("inf")) <= lim
                  for k, lim in cell.limits.items()) for nums in per]
    return worst, bool(per) and all(within), within.count(False)


def run(cot, cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
        device, t_process: float, clock=time.perf_counter) -> tuple:
    """Returns (the result object, the check's lines for stderr)."""
    import torch

    cuda = device.type == "cuda"
    build = importlib.import_module(cot.__name__ + ".ops._build")
    t = clock()
    if cuda:
        build.load()
    importlib.import_module(cot.__name__ + ".utils.native").have_native()
    t_load = clock() - t
    job_mod = spec.job_module(cell.kind)
    job = job_mod.Job(cot, cell, device)

    t = clock()
    count = int(cell.traffic.get("instances", 1))
    seeds = data.instance_seeds(cell.config, count)
    job.prepare([data.make_instance(s, cell.config, device) for s in seeds])
    order = data.order(seed, count)
    if cuda:
        torch.cuda.synchronize()
    t_data = clock() - t
    t = clock()
    job.warmup()
    t_warm = clock() - t
    setup_s = clock() - t_process

    spans: list = []
    traces: list = []

    def request(k: int, profiled: int) -> None:
        i = order[k % count]
        if profiled:
            traces.append(trace_mod.profile(
                lambda: job.request(clock, i), dict(build.launches),
                lambda: dict(build.launches), host=profiled == 2,
                clock=clock))
        else:
            spans.append(job.request(clock, i))

    win = window_mod.run_window(request, seconds, traces=2 if trace else 0,
                                clock=clock, cycle=count)
    summary = None
    if traces:
        summary = dataclasses.replace(traces[0], idle=traces[1].idle)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    outputs = list(job.outputs)
    job.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, on the benchmark's own data drawn again
    t = clock()
    worst, ok, failed = judge_all(
        job_mod.judge,
        lambda i: data.make_instance(seeds[i], cell.config, device),
        cell, outputs)
    t_check = clock() - t

    lines = [f"setup: load {t_load:.3f} s (build {build.build_seconds:.3f}"
             f" s), data {t_data:.3f} s, warm-up {t_warm:.3f} s, "
             f"setup_s {setup_s:.3f} s",
             f"window: {win.requests} requests in {win.seconds:.3f} s "
             f"(instances in the order {order}), "
             f"ends {[round(e, 3) for e in win.ends]}",
             f"spans: {spans}",
             f"reference check: {t_check:.3f} s"]
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(peak)}
    if trace:
        rec = RunRecord(cell=cell, spans=spans, trace=summary,
                        device_name=name)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            lines.append(f"trace: calls by kernel {summary.ops_calls()}; "
                         f"launches counted by the program "
                         f"{summary.launches}; device trace busy "
                         f"{summary.busy_s:.3f} s of {summary.window_s:.3f}"
                         f" s; host trace busy {traces[1].busy_s:.3f} s of "
                         f"{traces[1].window_s:.3f} s")
    else:
        per_job = {job_mod.METRIC: win.per_request(), "setup_s": setup_s}
        metrics = {m["name"]: {"value": per_job[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in per_job}
    check = {k: {"value": v, "limit": cell.limits.get(k)}
             for k, v in worst.items()}
    lines += [f"check {k}: {v['value']!r} <= {v['limit']!r}"
              for k, v in check.items()]
    result = {"correct": ok, "attempted": len(outputs), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        result["breakdown"] = summary.breakdown()
    result["check"] = check
    return result, lines

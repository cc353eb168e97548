"""Find a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic; every
other piece is a file found by a name:

    benchmark/configs/<config>.json      sizes and guarantees of a deployment
    benchmark/traffic/<traffic>.json     the job: its kind and parameters
    benchmark/jobs/<kind>.py             the code that drives one kind of job
    benchmark/workloads/<cell>.json      the limits that decide ``correct``
    benchmark/metrics/<metric>.py        a per-layer metric's reader
    benchmark/roofline/<kernel>.py       a kernel's frozen work function

A later cell adds files and entries; it edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file whose name may hold dots (``metrics/iters.cert.py``)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    limits: dict            # number name -> limit
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["job"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` with its files read; raises KeyError for a cell
    that ``BENCHMARK.json`` does not name."""
    root = os.path.dirname(bench_dir)
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     w["traffic"] + ".json"))
    limits = load_json(os.path.join(bench_dir, "workloads",
                                    name + ".json"))["limits"]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def job_module(kind: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "jobs", kind + ".py"),
                       f"bench_job_{kind}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))


def roofline(kernel: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "roofline", kernel + ".py"),
                       "bench_roofline_" + kernel)

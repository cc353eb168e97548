"""The harness finds every piece of a cell by name, and BENCHMARK.json
keeps to the contract's shape."""

import json
import os
import re
import shutil

import pytest

from benchlib import spec

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    c = spec.find_cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    job = spec.job_module(c.kind)
    assert any(m["name"] == job.METRIC for m in c.end_to_end)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k5"])
def test_roofline_files_resolve(kernel):
    mod = spec.roofline(kernel)
    assert mod.KERNELS and callable(mod.work)


def test_files_are_named_from_name_characters():
    for dirpath, _, files in os.walk(spec.BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    """A later cell adds a configuration, a traffic mix and its limits as
    new files, and entries in BENCHMARK.json; the harness finds them."""
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (bench_dir / sub).mkdir(parents=True)
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                      "lasso-5kx50k.json"))
    cfg.update(name="lasso-500x2000", m=500, n=2000)
    (bench_dir / "configs" / "lasso-500x2000.json").write_text(
        json.dumps(cfg))
    (bench_dir / "traffic" / "ista-path.json").write_text(json.dumps(
        {"job": "path", "method": "ista",
         "solver": {"gap_every": 10, "max_iters": 100}}))
    (bench_dir / "workloads" / "lasso-500x2000.ista-path.json").write_text(
        json.dumps({"limits": {"gap_conv": 1e-4}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "lasso-500x2000", "source": "x",
                             "file": "benchmark/configs/lasso-500x2000.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "lasso-500x2000.ista-path",
                               "config": "lasso-500x2000",
                               "traffic": "ista-path", "chips": 1,
                               "why": "x"})
    c = spec.find_cell("lasso-500x2000.ista-path", bench=bench,
                       bench_dir=str(bench_dir))
    assert c.kind == "path" and c.config["m"] == 500
    assert c.traffic["method"] == "ista"
    assert {m["name"] for m in c.end_to_end} == {"setup_s"}
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell")
    shutil.rmtree(tmp_path)

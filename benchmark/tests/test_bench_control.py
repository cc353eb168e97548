"""The control (the plain reference one precision down, in the program's
place) comes out not correct under each cell's limits.  Here at a small
size on the CPU; ``readings.py --control`` reads it on the card at the
cells' own sizes (PERF.md gives those readings)."""

import dataclasses
import pytest
import torch

from benchlib import cell_run, control, data, spec

SIZES = {"lasso-10kx100k": (400, 2000), "lasso-5kx50k": (400, 2000)}
SEEDS = (2**33 + 1, 2**33 + 2, 2**33 + 3)


def small(name):
    c = spec.find_cell(name)
    m, n = SIZES[c.config["name"]]
    return dataclasses.replace(c, config={**c.config, "m": m, "n": n})


def judged(cell, inst, out):
    return cell_run.judge_all(spec.job_module(cell.kind).judge,
                              lambda i: inst, cell, [{**out, "instance": 0}])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000001])
    q = control.tf32(x)
    assert q.tolist()[0] == 1.0 and q.tolist()[3] == -3.0
    assert q[1] == 1.0 + 2**-10          # a tie rounds away from zero
    assert q[2] == 1.0 + 2**-10          # 2**-12 is below the last bit
    assert torch.all((q.view(torch.int32) & 0x1FFF) == 0)


@pytest.mark.parametrize("name", ["lasso-10kx100k.bcd-cert",
                                  "lasso-10kx100k.fista-cert"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cert_control_fails(name, seed):
    cell = small(name)
    inst = data.make_instance(data.instance_seed(seed), cell.config, "cpu")
    worst, ok, _ = judged(cell, inst, control.cert(inst, cell.config,
                                                    cell.traffic))
    assert not ok, worst


@pytest.mark.parametrize("name", ["lasso-5kx50k.batch-path",
                                  "lasso-5kx50k.fista-path"])
@pytest.mark.parametrize("seed", SEEDS)
def test_path_control_fails(name, seed):
    cell = small(name)
    inst = data.make_instance(data.instance_seed(seed), cell.config, "cpu")
    worst, ok, _ = judged(cell, inst, control.path(inst, cell.config,
                                                    cell.traffic))
    assert not ok, worst


@pytest.mark.cuda
def test_cert_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = dataclasses.replace(spec.find_cell("lasso-10kx100k.bcd-cert"),
                               config={**small("lasso-10kx100k.bcd-cert")
                                       .config, "m": 2000, "n": 20000})
    inst = data.make_instance(data.instance_seed(SEEDS[0]), cell.config,
                              torch.device("cuda"))
    _, ok, _ = judged(cell, inst, control.cert(inst, cell.config,
                                               cell.traffic))
    assert not ok

"""The frozen work functions at the cells' shapes give the bounds of the
kernel table (PERF.md: K1 1.194 ms, K2/K3 0.2986 ms at config 2, K5
0.300 ms) at the H100's published peaks."""

import pytest

from benchlib import peaks, readers, spec

H100 = "NVIDIA H100 80GB HBM3"
BIG = spec.load_json(f"{spec.BENCH_DIR}/configs/lasso-10kx100k.json")
PATH = spec.load_json(f"{spec.BENCH_DIR}/configs/lasso-5kx50k.json")
TRAFFIC = {"solver": {"block_size": 128}}


@pytest.mark.parametrize("kernel, config, ms", [
    ("k1", BIG, 1.194), ("k2", BIG, 1.194), ("k3", BIG, 1.194),
    ("k2", PATH, 0.2986), ("k3", PATH, 0.2986), ("k5", PATH, 0.300)])
def test_bounds(kernel, config, ms):
    work = spec.roofline(kernel).work(config, TRAFFIC)
    got = 1e3 * peaks.bound_s(work, H100)
    assert got == pytest.approx(ms, abs=5e-4 if ms != 0.2986 else 5e-5)


def test_block_width_and_peaks():
    assert readers.block_width(100_000, 128) == 80
    assert readers.block_width(50_000, 128) == 80
    assert peaks.peaks("cpu") is None
    assert peaks.peaks(H100) == (3.35e12, 67e12)

"""The trace reduction on a hand-made Chrome trace."""

import pytest

from benchlib import trace


def ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


EVENTS = [
    ev("bench.request", "user_annotation", 0, 1000),
    ev("bench.solve", "user_annotation", 0, 600),
    ev("aten::item", "cpu_op", 300, 100),
    ev("cudaStreamSynchronize", "cuda_runtime", 310, 80),
    ev("bench.polish", "user_annotation", 600, 400),
    ev("void (anonymous namespace)::sweep_kernel<(Penalty)0, true>"
       "(float const*)", "kernel", 100, 200, 7),
    ev("void batch_sweep_kernel<4>(float const*)", "kernel", 250, 100, 7),
    ev("void (anonymous namespace)::ax_partial_kernel<true>(float const*)",
       "kernel", 400, 50, 7),
    ev("(anonymous namespace)::ax_finish_kernel(float const*)", "kernel",
       450, 10, 7),
    ev("Memset (Device)", "gpu_memset", 460, 5, 7),
    ev("void (anonymous namespace)::sweep_kernel<(Penalty)0, true>"
       "(float const*)", "kernel", 2000, 10, 7),
]


def test_summary():
    s = trace.summarize(EVENTS, {"sweep_t": 1})
    assert s.window_s == pytest.approx(1000e-6)
    # busy: [100, 350] U [400, 465]
    assert s.busy_s == pytest.approx(315e-6)
    assert s.kernel("sweep_kernel") == (1, pytest.approx(200e-6))
    assert s.kernel("batch_sweep_kernel")[0] == 1
    assert s.kernel("ax_partial_kernel")[0] == 1
    assert s.kernel("neg_at_r_kernel") == (0, 0.0)
    # gaps [0, 100], [350, 400], [465, 1000], named at their middles
    assert s.idle == pytest.approx({
        "bench.solve": 100e-6,
        "bench.solve/cudaStreamSynchronize": 50e-6,
        "bench.polish": 535e-6})
    b = s.breakdown()
    assert b["device_ops"][0] == ["sweep_kernel<(Penalty)0, true>",
                                  pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) == 3


def test_no_request_span():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])


def test_device_trace():
    """A device trace has no host spans: the benchmark's clock gives the
    request's length, and every device operation in it belongs to it."""
    dev = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS]
    s = trace.summarize(dev, None, window_s=0.004)
    assert s.window_s == 0.004 and s.idle == {}
    assert s.busy_s == pytest.approx(325e-6)
    assert s.kernel("sweep_kernel")[0] == 2

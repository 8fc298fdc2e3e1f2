"""The metric arithmetic: the interval union and the trace reading, the
work counts, the 95th percentile over all epochs."""

import pytest

from benchmark import harness, trace, work


def test_union_and_merge():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert trace.union_us(iv) == 4.0
    assert trace.merged(iv) == [[0, 3], [5, 6], [10, 10]]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_window():
    t = {"traceEvents": [
        _ev("bench_window", "user_annotation", 100, 100),
        _ev("train_step", "user_annotation", 100, 60),
        _ev("aten::mm", "cpu_op", 100, 20),
        _ev("k1", "kernel", 90, 30),        # clipped to [100, 120]
        _ev("k2", "kernel", 150, 10),
        _ev("k1", "kernel", 190, 20),       # clipped to [190, 200]
        _ev("copy", "gpu_memcpy", 155, 10),
        _ev("k3", "kernel", 300, 10),       # outside the window
    ]}
    s = trace.summarize(t)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)     # 20 + 15 + 10
    assert s["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    gaps = dict(s["idle_gaps"])
    # [120, 150] in the train step, [165, 190] after it
    assert gaps["train_step:none"] == pytest.approx(30e-6)
    assert gaps["outside:none"] == pytest.approx(25e-6)


def test_spmm_work():
    flops, nbytes = work.spmm(nnz=10, n_out=4, n_in=5, f=2)
    assert flops == 40
    assert nbytes == 8 * 10 + 4 * 5 + 4 * 5 * 2 + 4 * 4 * 2
    t, bound = work.least_seconds(67e12, 1.0)
    assert bound == "ops" and t == pytest.approx(1.0)
    t, bound = work.least_seconds(1.0, 3.35e12)
    assert bound == "bytes" and t == pytest.approx(1.0)


def test_attention_work():
    flops, nbytes = work.attention_forward(n=3, edges=7, heads=2, feat=4)
    assert flops == 7 * 2 * (2 * 4 + 4) + 3 * 2 * 4
    assert nbytes == 4 * 7 + 4 * 4 + 8 * 3 * 2 + 8 * 3 * 2 * 4


def test_epoch_work_counts_the_hop_products():
    import torch

    from benchmark import graphs
    from benchmark.tests.conftest import TINY

    cell = harness.Cell("h2gcn2.squirrel")
    g = graphs.generate(TINY["h2gcn2.squirrel"], 1)
    flops, _ = cell.reference.epoch_work(g, torch.device("cpu"))
    # at least the 12 hop products at widths 64 and 128
    assert flops > 2 * 2 * g.src.size * (64 + 128) * 3


def test_p95_over_all_epochs():
    times = [float(i) for i in range(1, 201)]
    assert harness.p95(times) == 190.0
    assert harness.p95([3.0, 1.0, 2.0]) == 3.0

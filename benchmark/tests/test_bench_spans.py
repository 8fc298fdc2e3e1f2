"""The readers of the program's spans and counters (``metrics/_spans.py``
and the six metrics on it) at the small sizes on the CPU, and against a
program that has no tracer."""

import os
import tempfile
import time
import types

import pytest

from benchmark import graphs, harness
from benchmark.tests.conftest import TINY, tiny_cell

NEW = {"h2gcn2.squirrel": ("readbacks_per_epoch", "spmm_host_us", "load_s"),
       "gat.arxiv-year": ("optimizer_ms.host_paced",
                          "readbacks_per_epoch.host_paced", "load_s",
                          "payload_s")}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "bench_metric_" + name.replace(".", "_"))


@pytest.fixture(scope="module", params=sorted(NEW))
def traced_line(request):
    w = request.param
    return w, harness.run_cell(w, 5, 0.3, True, t_start=time.perf_counter(),
                               device="cpu", cell=tiny_cell(w),
                               traffic=TINY[w])


def test_each_cell_reports_its_new_metrics(traced_line):
    w, r = traced_line
    m = r["metrics"]
    assert r["correct"] and r["failed"] == 0
    for name in NEW[w]:
        assert m[name]["value"] > 0, name
    # after the warm-up: the printer's 6, best-val's 2, and the sliding
    # mean's 1 (H2GCN-2) or GAT's patience 2
    if w == "h2gcn2.squirrel":
        assert m["readbacks_per_epoch"]["value"] == 9
        assert m["spmm_host_us"]["unit"] == "us"
    else:
        assert m["readbacks_per_epoch.host_paced"]["value"] == 10
        assert m["optimizer_ms.host_paced"]["unit"] == "ms"


def test_the_stretch_is_counted_once():
    w = "h2gcn2.squirrel"
    cell = tiny_cell(w)
    graph = graphs.generate(TINY[w], 6)
    with tempfile.TemporaryDirectory() as d, open(os.devnull, "w") as sink:
        prog = harness.Program(cell, graph, 6, "cpu", d, sink)
        run = types.SimpleNamespace(program=prog, epoch_s=10.0, attempted=7,
                                    failed=0)
        epochs0 = prog.args.current_epoch
        first = _reader("spmm_host_us").read(run)
        again = _reader("readbacks_per_epoch").read(run)
    assert first > 0 and again == pytest.approx(
        (9 * 19 + 7) / 20)  # the stretch's first epoch has no best yet
    assert run.attempted == 7 + 20 and run.failed == 0
    assert prog.args.current_epoch - epochs0 == 20
    assert _reader("load_s").read(run) > 0
    assert _reader("payload_s").read(run) is None  # no GAT payload


def test_a_program_without_a_tracer_reads_nothing(monkeypatch):
    sp = harness.load_module(harness.BENCH / "metrics" / "_spans.py",
                             "bench_spans_test")
    monkeypatch.setattr(sp, "_tracing", lambda: None)
    ran = []
    prog = types.SimpleNamespace(objects={"spans": object()},
                                 train_and_eval=lambda *a: ran.append(1))
    run = types.SimpleNamespace(program=prog, epoch_s=0.01, attempted=3,
                                failed=0)
    assert sp.stretch(run) is None and not ran and run.attempted == 3
    # the parent's CLI hands out no store
    run = types.SimpleNamespace(program=types.SimpleNamespace(objects={}))
    for name in ("optimizer_ms.host_paced", "readbacks_per_epoch",
                 "readbacks_per_epoch.host_paced", "spmm_host_us", "load_s",
                 "payload_s"):
        assert _reader(name).read(run) is None, name

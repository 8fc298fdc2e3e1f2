"""The cells ``gcnii.arxiv-year`` and ``h2gcn2.arxiv-year`` through the
harness's own run on the CPU, at a small arXiv-year-shaped graph, and the
three GCNII readers (``prop_roofline_pct``, ``gcnii_layer_host_us``,
``gcnii_layers_per_epoch``) against a fake stretch and a program without
a tracer."""

import subprocess
import sys
import time
import types

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

# arXiv-year's kind at a small size: dense uniform features, 5 classes, a
# random split
ARXIV_TINY = dict(nodes=300, edges=1500, features=16, feature_kind="uniform",
                  classes=5, degree_exponent=0.6, graph_seed=0,
                  split={"kind": "random", "train": 0.5, "val": 0.25})
CELLS = ("gcnii.arxiv-year", "h2gcn2.arxiv-year")


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "bench_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("workload", CELLS)
def test_run_is_correct_on_cpu(workload):
    cell = harness.Cell(workload)
    r = harness.run_cell(workload, 2400000077, 0.3, False,
                         t_start=time.perf_counter(), device="cpu",
                         cell=cell, traffic=ARXIV_TINY)
    assert r["correct"], r["checks"]
    assert r["attempted"] > harness.DEVICE_EPOCHS and r["failed"] == 0
    assert set(r["checks"]) == set(cell.limits)
    # the device's busy time is a card's reading: the CPU gives none
    assert set(r["metrics"]) == {m["name"] for m in cell.metrics(False)
                                 if m["name"] != "epoch_device_ms"}
    assert {"setup_s", "peak_mem_gib"} <= set(r["metrics"])


def test_traced_run_reads_the_layers():
    w = "gcnii.arxiv-year"
    r = harness.run_cell(w, 5, 0.3, True, t_start=time.perf_counter(),
                         device="cpu", traffic=ARXIV_TINY)
    m = r["metrics"]
    assert r["correct"] and r["failed"] == 0
    # 64 layers in the training forward and 64 in the evaluation's
    assert m["gcnii_layers_per_epoch"]["value"] == 128
    assert m["gcnii_layer_host_us"]["value"] > 0
    assert m["readbacks_per_epoch.host_paced"]["value"] == 9
    assert "prop_roofline_pct" not in m      # a card's reading


class _Rec:
    def __init__(self, name, seconds, parent=None):
        self.name, self.parent = name, parent
        self.seconds = seconds


def test_readers_on_a_fake_stretch():
    layers = [_Rec("gcnii.layer", 300e-6), _Rec("gcnii.layer", 500e-6)]
    records = [_Rec("spmm", 100e-6, layers[0]), _Rec("spmm", 200e-6,
                                                     layers[1]),
               _Rec("spmm", 999e-6)] + layers
    stretch = types.SimpleNamespace(epochs=2, records=records,
                                    counters={"gcnii.layers": 256,
                                              "readbacks": 18})
    run = types.SimpleNamespace(program_spans=stretch)
    # each layer outside its SpMM: 200 and 300 us
    assert _reader("gcnii_layer_host_us").read(run) == pytest.approx(250.0)
    assert _reader("gcnii_layers_per_epoch").read(run) == 128
    stretch.counters = {"readbacks": 18}       # a program without GCNII
    assert _reader("gcnii_layers_per_epoch").read(run) is None
    prog = types.SimpleNamespace(device=types.SimpleNamespace(type="cpu"),
                                 tensors={"adj_hops": []})
    assert _reader("prop_roofline_pct").read(
        types.SimpleNamespace(program=prog)) is None


def test_a_program_without_a_tracer_reads_nothing():
    # the parent's CLI hands out no store
    run = types.SimpleNamespace(program=types.SimpleNamespace(objects={}))
    for name in ("gcnii_layer_host_us", "gcnii_layers_per_epoch"):
        assert _reader(name).read(run) is None, name


_REF = """
import sys, torch
sys.path.insert(0, {root!r})
from benchmark import graphs, harness
from benchmark.tests.test_bench_gcnii import ARXIV_TINY
cell = harness.Cell("gcnii.arxiv-year")
g = graphs.generate(ARXIV_TINY, 3)
harness.reference_readings(cell, g, 3, torch.device("cpu"))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", _REF.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=600)
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "h2gcn_tpu",
                       "h2gcn_tpu_torch"}

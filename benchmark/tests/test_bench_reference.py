"""The plain reference against the program's CPU path at a small size,
through the harness's own run."""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark import graphs, harness, reference
from benchmark.tests.conftest import TINY, tiny_cell


@pytest.mark.parametrize("workload", sorted(TINY))
def test_run_is_correct_on_cpu(workload):
    cell = tiny_cell(workload)
    r = harness.run_cell(workload, 77, 0.5, False, t_start=time.perf_counter(),
                         device="cpu", cell=cell, traffic=TINY[workload])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(cell.limits)
    # the device's busy time is a card's reading: the CPU gives none
    assert set(r["metrics"]) == {m["name"] for m in cell.metrics(False)
                                 if m["name"] != "epoch_device_ms"}
    assert {"setup_s", "peak_mem_gib"} <= set(r["metrics"])
    if any(m["name"] == "epoch_device_ms" for m in cell.metrics(False)):
        # the profiled epochs after the window ran, and count as attempted
        assert r["attempted"] > harness.DEVICE_EPOCHS


def test_exact_hops_against_scipy():
    g = graphs.generate(TINY["h2gcn2.squirrel"], 9)
    (r1, c1), (r2, c2) = reference.exact_hops(g.src, g.dst, g.n,
                                              torch.device("cpu"))
    a = g.adjacency()
    ai = (a + sp.eye(g.n, format="csr")).astype(bool).astype(np.float32)
    two = ((ai @ ai) > 0).astype(np.int8) - (ai > 0).astype(np.int8)
    two = sp.coo_matrix(two)
    keep = two.data > 0
    want = sorted(zip(two.row[keep], two.col[keep]))
    assert list(zip(r2.tolist(), c2.tolist())) == want
    assert sorted(zip(r1.tolist(), c1.tolist())) == sorted(
        zip(*a.nonzero()))


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12])
    got = reference.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0])
    assert torch.equal(got, want)


def test_keras_adam_first_moment():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, -0.25])}
    opt = reference.KerasAdam(p, lr=0.01)
    opt.step(p, g)
    assert torch.allclose(opt.m["w"] / 0.1, g["w"])
    assert torch.all(torch.sign(p["w"] - torch.tensor([1.0, -2.0]))
                     == -torch.sign(g["w"]))

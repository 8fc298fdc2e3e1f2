"""The traffic generator at the published counts."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import graphs

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


@pytest.mark.parametrize("name", ["squirrel", "arxiv-year"])
def test_published_counts(name):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    g = graphs.generate(t, 3)
    assert g.n == t["nodes"]
    assert g.src.size == t["edges"]
    assert not np.any(g.src == g.dst)
    keys = np.minimum(g.src, g.dst) * g.n + np.maximum(g.src, g.dst)
    assert np.unique(keys).size == t["edges"]
    adj = g.adjacency()
    assert adj.nnz == 2 * t["edges"] and (adj != adj.T).nnz == 0
    assert g.features.shape == (t["nodes"], t["features"])
    if t["feature_kind"] == "binary":
        assert sp.issparse(g.features)
        assert np.all(np.diff(g.features.indptr) == t["feature_nnz_per_row"])
    counts = np.bincount(g.labels)
    assert counts.size == t["classes"] and counts.max() - counts.min() <= 1
    parts = np.concatenate([g.idx_train, g.idx_val, g.idx_test])
    assert np.array_equal(np.sort(parts), np.arange(g.n))
    assert abs(g.idx_train.size / g.n - t["split"]["train"]) < 0.01
    assert abs(g.idx_val.size / g.n - t["split"]["val"]) < 0.01


def test_seed_relabels_the_same_graph():
    t = json.loads((TRAFFIC / "squirrel.json").read_text())
    a, b, a2 = (graphs.generate(t, s) for s in (1, 2, 1))
    assert np.array_equal(a.src, a2.src) and np.array_equal(a.labels,
                                                            a2.labels)
    assert not np.array_equal(a.src, b.src)
    # the same degree sequence in another order
    da = np.sort(np.diff(a.adjacency().indptr))
    db = np.sort(np.diff(b.adjacency().indptr))
    assert np.array_equal(da, db)


def test_large_seed():
    t = dict(json.loads((TRAFFIC / "squirrel.json").read_text()),
             nodes=200, edges=800)
    g = graphs.generate(t, 2 ** 31 + 12345)
    assert g.src.size == 800


def test_sparsegraph_roundtrip(tmp_path):
    from h2gcn_tpu_torch.datasets.sparsegraph import SparseGraphData

    t = dict(json.loads((TRAFFIC / "squirrel.json").read_text()),
             nodes=200, edges=800, features=30, feature_nnz_per_row=4)
    g = graphs.generate(t, 5)
    path = tmp_path / "g.npz"
    graphs.write_sparsegraph(g, str(path))
    d = SparseGraphData(str(path), setting="exist")
    assert (d.sparse_adj != g.adjacency()).nnz == 0
    assert np.array_equal(np.nonzero(d.train_mask)[0], g.idx_train)
    assert np.array_equal(d.labels, g.labels)

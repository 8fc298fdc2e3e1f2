"""The GeomGCN and SparseGraph loaders of the PyTorch port against the JAX
package's, from the same written files (the fixtures of
tests/test_geomgcn.py and tests/test_extensions.py): features, labels,
adjacency and masks equal, the exported tensors equal, the npz format read
and written across the packages, the graph helpers equal, and both CLI
formats train end to end."""

import numpy as np
import pytest
import scipy.sparse as sp

from h2gcn_tpu.datasets import sparsegraph as j_sg
from h2gcn_tpu.datasets._dataset import GeomGCNData as JGeomGCNData
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.datasets import sparsegraph as t_sg
from h2gcn_tpu_torch.datasets._dataset import GeomGCNData

DENSE_KEYS = ("y_all", "train_mask", "val_mask", "test_mask", "wild_mask",
              "y_train", "y_val", "y_test", "y_wild")


def _write_geomgcn(path, film=False):
    """tests/test_geomgcn.py's 40-node files, plus node 40, which is in the
    feature file but in no edge (the loader drops it). ``film`` writes each
    node's features as indices of set bits among 932, some past 255."""
    rng = np.random.RandomState(0)
    n, f, c = 41, 8, 3
    feats = (rng.rand(n, f) > 0.5).astype(int)
    labels = rng.randint(0, c, n)
    with open(path / "out1_node_feature_label.txt", "w") as fh:
        fh.write("node_id\tfeature\tlabel\n")
        for i in range(n):
            if film:
                row = sorted({int(j) for j in rng.randint(0, 932, 6)})
            else:
                row = feats[i]
            fh.write(f"{i}\t{','.join(map(str, row))}\t{labels[i]}\n")
    edges = {(i, i + 1) for i in range(n - 2)}
    while len(edges) < 100:
        u, v = rng.randint(0, n - 1, 2)
        if u != v:
            edges.add((u, v))
    with open(path / "out1_graph_edges.txt", "w") as fh:
        fh.write("src\tdst\n")
        for u, v in sorted(edges):
            fh.write(f"{u}\t{v}\n")
    perm = np.random.RandomState(1).permutation(n - 1)
    masks = {key: np.isin(np.arange(n - 1), part).astype(np.int64)
             for key, part in zip(("train_mask", "val_mask", "test_mask"),
                                  (perm[:20], perm[20:30], perm[30:]))}
    np.savez(path / "split.npz", **masks)
    return str(path / "split.npz")


def _same_data(t, j):
    assert abs(t.sparse_adj - j.sparse_adj).nnz == 0
    assert t.sparse_adj.dtype == j.sparse_adj.dtype
    np.testing.assert_array_equal(t.features.toarray(), j.features.toarray())
    for key in DENSE_KEYS:
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key),
                                      err_msg=key)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.label_count, j.label_count)
    assert (t.num_samples, t.num_labels, t.feature_dim) == (
        j.num_samples, j.num_labels, j.feature_dim)


@pytest.mark.parametrize("name,split,directed", [
    ("toy", False, False), ("toy", True, False), ("toy", True, True),
    ("film", True, False)])
def test_geomgcn_matches_jax(tmp_path, name, split, directed):
    split_file = _write_geomgcn(tmp_path, film=name == "film")
    kw = dict(splits_file_path=split_file if split else None,
              directed_graph=directed)
    t = GeomGCNData(name, str(tmp_path), **kw)
    j = JGeomGCNData(name, str(tmp_path), **kw)
    _same_data(t, j)
    assert t.num_samples == 40  # node 40 has no edge
    assert t.splitted == j.splitted == split
    if name == "film":
        assert t.feature_dim == 932 and t.features[:, 256:].nnz > 0
    assert (abs(t.sparse_adj - t.sparse_adj.T).nnz == 0) != directed


def test_geomgcn_tensors_match_jax(tmp_path):
    split_file = _write_geomgcn(tmp_path)
    out = []
    for cls in (GeomGCNData, JGeomGCNData):
        ds = cls("toy", str(tmp_path), splits_file_path=split_file)
        ds.row_normalize_features()
        ds.adj_remove_eye()
        out.append(ds.get_tensors(get_adj_norm_hops=["1", "2"],
                                  backend="segment"))
    t, j = out
    for a, b in zip(t.adj_hops + [t.adj], j.adj_hops + [j.adj]):
        assert a.nnz == b.nnz
        assert abs(a.to_scipy() - b.to_scipy()).max() <= 1e-7
    for key in ("features", "labels") + DENSE_KEYS:
        np.testing.assert_array_equal(getattr(t, key).numpy(),
                                      np.asarray(getattr(j, key)),
                                      err_msg=key)


def _toy_graph(n=80, seed=0, unknown=0):
    """tests/test_extensions.py's SparseGraph; ``unknown`` nodes carry the
    label -1 and a second component hangs off the first's last node ids."""
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=0.08, random_state=1, format="csr")
    a = ((a + a.T) > 0).astype(np.float32)
    labels = rng.randint(0, 3, n)
    labels[:unknown] = -1
    feats = sp.csr_matrix(rng.rand(n, 12).astype(np.float32))
    return a, feats, labels


@pytest.mark.parametrize("writer,reader", [(j_sg, t_sg), (t_sg, j_sg)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_npz_round_trip_across_packages(tmp_path, writer, reader):
    a, feats, labels = _toy_graph()
    g = writer.SparseGraph(a, feats, labels,
                           node_names=np.array([f"n{i}" for i in range(80)]),
                           class_names=np.array(["a", "b", "c"]))
    writer.save_sparse_graph_to_npz(tmp_path / "g", g)
    h = reader.load_npz_to_sparse_graph(tmp_path / "g.npz")
    assert abs(h.adj_matrix - g.adj_matrix).nnz == 0
    np.testing.assert_array_equal(h.attr_matrix.toarray(), feats.toarray())
    np.testing.assert_array_equal(h.labels, labels)
    np.testing.assert_array_equal(h.node_names, g.node_names)
    np.testing.assert_array_equal(h.class_names, g.class_names)
    # a dense attribute matrix and one-hot CSR labels load too
    np.savez(tmp_path / "d.npz", adj_data=a.data, adj_indices=a.indices,
             adj_indptr=a.indptr, adj_shape=a.shape,
             attr_matrix=feats.toarray(),
             labels_data=np.ones(80), labels_indices=labels,
             labels_indptr=np.arange(81), labels_shape=(80, 3))
    d = reader.load_dataset(tmp_path / "d")
    np.testing.assert_array_equal(d.labels, labels)
    assert isinstance(d.attr_matrix, np.ndarray)


def _graph_of(pkg, a, feats, labels):
    return pkg.SparseGraph(a.copy(), feats.copy(), labels.copy())


def test_graph_helpers_match_jax():
    """LCC, subgraphs, standardize, underrepresented classes, binarized
    labels and the adjacency normalizations."""
    a, feats, labels = _toy_graph(n=120, seed=2)
    a = sp.block_diag([a[:100, :100], sp.csr_matrix(np.ones((20, 20)))])
    a = sp.csr_matrix(a, dtype=np.float32)
    labels[100:] = 2
    labels[:5] = 0
    pairs = [_graph_of(pkg, a, feats, labels) for pkg in (t_sg, j_sg)]
    t, j = [p.standardize() for p in pairs]
    assert abs(t.adj_matrix - j.adj_matrix).nnz == 0
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.attr_matrix.toarray(),
                                  j.attr_matrix.toarray())
    assert t.num_nodes() == j.num_nodes() < 120
    for n_comp in (1, 2):
        t, j = [pkg.largest_connected_components(
            _graph_of(pkg, a, feats, labels), n_comp) for pkg in (t_sg, j_sg)]
        assert abs(t.adj_matrix - j.adj_matrix).nnz == 0
        np.testing.assert_array_equal(t.labels, j.labels)
    t, j = [pkg.remove_underrepresented_classes(
        _graph_of(pkg, a, feats, labels), 10, 15) for pkg in (t_sg, j_sg)]
    np.testing.assert_array_equal(t.labels, j.labels)
    assert abs(t.adj_matrix - j.adj_matrix).nnz == 0
    t, j = [pkg.create_subgraph(_graph_of(pkg, a, feats, labels),
                                nodes_to_remove=[3, 50, 7])
            for pkg in (t_sg, j_sg)]
    assert abs(t.adj_matrix - j.adj_matrix).nnz == 0
    for fn in ("normalize_adj", "renormalize_adj", "row_normalize",
               "to_binary_bag_of_words"):
        m = feats if fn in ("row_normalize", "to_binary_bag_of_words") else a
        assert abs(getattr(t_sg, fn)(m) - getattr(j_sg, fn)(m)).max() < 1e-7
    for out in ({}, dict(sparse_output=True, return_classes=True)):
        got, ref = t_sg.binarize_labels(labels, **out), \
            j_sg.binarize_labels(labels, **out)
        if out:
            assert abs(got[0] - ref[0]).nnz == 0
            np.testing.assert_array_equal(got[1], ref[1])
        else:
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("setting,kw", [
    ("gcn", {}), ("gcn", dict(seed=3, val_size=10)),
    ("gcn", dict(require_lcc=True)), ("exist", {}),
    ("nettack", dict(require_lcc=True))])
def test_sparsegraph_data_matches_jax(tmp_path, setting, kw):
    a, feats, labels = _toy_graph(unknown=4)
    t_sg.save_sparse_graph_to_npz(tmp_path / "toy",
                                  t_sg.SparseGraph(a, feats, labels))
    if setting == "exist":
        with np.load(tmp_path / "toy.npz", allow_pickle=True) as f:
            fields = dict(f)
        rng = np.random.RandomState(4)
        order = rng.permutation(80)
        np.savez(tmp_path / "toy.npz", **fields, idx_train=order[:20],
                 idx_val=order[20:40], idx_test=order[40:])
    path = str(tmp_path / "toy.npz")
    t = t_sg.SparseGraphData(path, setting=setting, **kw)
    j = j_sg.SparseGraphData(path, setting=setting, **kw)
    _same_data(t, j)
    assert not t.train_mask[:4].any()  # unknown labels: in no split
    # the shared base's preprocessing and export
    for ds in (t, j):
        ds.row_normalize_features()
        ds.adj_remove_eye()
    np.testing.assert_array_equal(t.features.toarray(), j.features.toarray())
    tt = t.get_tensors(get_adj_norm_hops=["1"], backend="segment")
    jt = j.get_tensors(get_adj_norm_hops=["1"], backend="segment")
    assert abs(tt.adj_hops[0].to_scipy() - jt.adj_hops[0].to_scipy()).max() \
        <= 1e-7
    np.testing.assert_array_equal(tt.train_mask.numpy(),
                                  np.asarray(jt.train_mask))


def test_cli_trains_on_both_formats(tmp_path):
    a, feats, labels = _toy_graph()
    t_sg.save_sparse_graph_to_npz(tmp_path / "toy",
                                  t_sg.SparseGraph(a, feats, labels))
    split_file = _write_geomgcn(tmp_path)
    for fmt, extra in (("sparsegraph", ("--split_seed", "3")),
                       ("geomgcn", ("--splits_file_path", split_file))):
        args = run_experiments.main([
            "H2GCN", fmt, "--dataset", "toy", "--dataset_path",
            str(tmp_path), "--device", "cpu", "--epochs", "3", "--hidden",
            "8", "--checkpoint_dir", str(tmp_path / f"ck_{fmt}"), *extra])
        assert args.current_epoch == 3
        best = args.objects["best_val_stats"]
        for key in ("train_loss", "val_loss", "test_loss"):
            assert np.isfinite(float(best[key])), (fmt, key)

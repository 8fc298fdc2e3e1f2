"""The port's experiment pipeline modules against the JAX package's:
generator, statistics, feature and split generation.

The twins of ``tests/test_experiments.py`` run on the port's modules
(``h2gcn_tpu_torch.experiments``); the parity tests hold the port's output
to the JAX package's for the same seed: the same adjacency lists and
colors, the same statistics (exact, or 1e-12 where a float sum may
reassociate), the same split files byte for byte, so the same md5 and run
ids. Where the JAX tests read Cora from the reference tree, the twins read
a synthetic Planetoid source written here (``chip_smoke.write_planetoid``).
"""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp

import chip_smoke
from h2gcn_tpu.experiments import feature_generation as j_fg
from h2gcn_tpu.experiments import graph_stats as j_stats
from h2gcn_tpu.experiments import graphgen as j_gen
from h2gcn_tpu.experiments import workflow as j_workflow
from h2gcn_tpu.modules import runstore as j_store
from h2gcn_tpu_torch.experiments import feature_generation as fg
from h2gcn_tpu_torch.experiments import graph_stats
from h2gcn_tpu_torch.experiments import graphgen as t_gen
from h2gcn_tpu_torch.experiments import workflow
from h2gcn_tpu_torch.experiments.graphgen import (
    GraphGenerator,
    MixhopGraphGenerator,
    adj_lists_to_scipy,
)
from h2gcn_tpu_torch.modules import runstore as t_store

STATS_TOL = 1e-12


@pytest.fixture(scope="module")
def syn_graph():
    rng = np.random.RandomState(42)
    gen = MixhopGraphGenerator([100, 100, 100], hetero_weights_exponent=1.0,
                               rng=rng)
    adj_lists, colors = gen(300, 2, 6, h=0.8)
    return gen, adj_lists, colors


@pytest.fixture(scope="module")
def planetoid_source(tmp_path_factory):
    """A synthetic Planetoid source in place of Cora's raw files: 800 nodes,
    7 classes, 1,433 sparse binary features."""
    path = tmp_path_factory.mktemp("planetoid")
    adj = chip_smoke.build_graph(n=800, m_edges=2400, seed=3)
    chip_smoke.write_planetoid(str(path), "syncora", adj, seed=3,
                               train_per_class=20, n_test=100)
    return str(path)


def _ally(colors, n_classes):
    ally = np.zeros((len(colors), n_classes))
    ally[np.arange(len(colors)), colors - 1] = 1
    return ally


# ------------------------------------------------ twins of test_experiments
def test_generator_basic_properties(syn_graph):
    gen, adj_lists, colors = syn_graph
    assert len(adj_lists) == 300
    assert [np.sum(colors == c) for c in (1, 2, 3)] == [100, 100, 100]
    for u, nbrs in adj_lists.items():
        assert u not in nbrs
        for v in nbrs:
            assert u in adj_lists[v]


def test_generator_homophily_tracks_h():
    ratios = []
    for h in (0.1, 0.9):
        gen = MixhopGraphGenerator([150, 150], rng=np.random.RandomState(1))
        adj_lists, colors = gen(300, 2, 4, h=h)
        A = adj_lists_to_scipy(adj_lists)
        ratios.append(graph_stats.getHomoEdgeRatio(A, colors)["homoEdgeRatio"])
    assert ratios[0] < 0.35 and ratios[1] > 0.65


def test_mixing_matrix():
    gen = MixhopGraphGenerator([1, 1, 1, 1, 1], hetero_weights_exponent=2.0)
    H = gen.getH(0.4)
    assert H.shape == (5, 5)
    np.testing.assert_allclose(np.diag(H), 0.4)
    np.testing.assert_allclose(H.sum(1), H.sum(1)[0])
    np.testing.assert_array_equal(
        H, j_gen.MixhopGraphGenerator([1] * 5,
                                      hetero_weights_exponent=2.0).getH(0.4))


def _nx_graph(A):
    nx = pytest.importorskip("networkx")
    return nx, nx.from_scipy_sparse_array(A)


def test_stats_against_networkx(syn_graph):
    _, adj_lists, colors = syn_graph
    A = adj_lists_to_scipy(adj_lists)
    nx, G = _nx_graph(A)
    n = A.shape[0]
    stats = graph_stats.calculate_statistics(
        A, colors, _ally(colors, 3),
        statepoint=dict(method="mixhop", classRatio=[1, 1, 1], h=0.8,
                        heteroWeightsExponent=1.0))
    assert stats["numNodes"] == n
    assert stats["numEdges"] == G.number_of_edges()
    np.testing.assert_allclose(stats["avgClusteringCoeff"],
                               nx.average_clustering(G), atol=1e-9)
    assert stats["numComponents"] == nx.number_connected_components(G)
    assert stats["numTotalTriangles"] == sum(nx.triangles(G).values()) // 3
    assert stats["numSelfLoops"] == 0
    np.testing.assert_allclose(stats["eH"].sum(1), 1.0, atol=1e-9)
    assert stats["H"].shape == (3, 3)
    betas = [np.mean([colors[u] == colors[v] for u in G.neighbors(v)])
             for v in G.nodes if list(G.neighbors(v))]
    np.testing.assert_allclose(stats["GeomGCNBeta"], np.mean(betas),
                               atol=1e-9)


def test_avg_shortest_path(syn_graph):
    _, adj_lists, _ = syn_graph
    A = adj_lists_to_scipy(adj_lists)
    nx, G = _nx_graph(A)
    got = graph_stats.getAvgShortestPath(A)["avgSPLength"]
    pair_count, dist_count = 0, 0.0
    for comp in nx.connected_components(G):
        if len(comp) < 2:
            continue
        count = len(comp) * (len(comp) - 1)
        dist_count += nx.average_shortest_path_length(G.subgraph(comp)) * count
        pair_count += count
    np.testing.assert_allclose(got, dist_count / pair_count, rtol=1e-9)


def test_select_indices_modes():
    rng = np.random.RandomState(0)
    n = 60
    ally = np.zeros((n, 3))
    ally[np.arange(n), np.arange(n) % 3] = 1
    sampled = np.zeros(n, bool)
    per_class = fg.select_indices("5c", sampled, n, ally, 3, rng)
    assert len(per_class) == 15 and sampled.sum() == 15
    ratio = fg.select_indices("0.5p", sampled, n, ally, 3, rng)
    assert len(ratio) == 30
    rest = fg.select_indices("", sampled, n, ally, 3, rng)
    assert sampled.all()
    assert len(rest) == n - 45


def test_generate_split_roundtrip(tmp_path, syn_graph):
    from h2gcn_tpu_torch.datasets._dataset import PlanetoidData

    _, adj_lists, colors = syn_graph
    n = len(adj_lists)
    ally = _ally(colors, 3)
    allx = np.random.RandomState(7).rand(n, 12)
    result = fg.generate_split(adj_lists, ally, allx, "0.25p__0.5p",
                               tmp_path, "syn-test",
                               rng=np.random.RandomState(3))
    assert result is not None
    ds = PlanetoidData("syn-test", str(tmp_path), val_size=None)
    assert ds.num_samples == n and ds.num_labels == 3
    assert ds.train_mask.sum() == 75
    assert ds.test_mask.sum() == 150
    assert ds.val_mask.sum() == result["val_size"] == 75
    assert ds.train_mask[:75].all()
    feats = np.asarray(ds.features.todense())
    for old, new in list(result["node_mapping"].items())[:50]:
        np.testing.assert_allclose(feats[new], allx[old], atol=1e-6)
    assert sorted(np.asarray(ds.sparse_adj.sum(1)).ravel()) == sorted(
        np.asarray(adj_lists_to_scipy(adj_lists).sum(1)).ravel())


def test_row_sample(planetoid_source):
    from h2gcn_tpu_torch.datasets._dataset import PlanetoidData

    cora = PlanetoidData("ind.syncora", planetoid_source, val_size=500)
    n = 90
    ally = np.zeros((n, 3))
    ally[np.arange(n), np.arange(n) % 3] = 1
    allx = fg.row_sample(ally, cora, rng=np.random.RandomState(0))
    assert allx.shape == (n, cora.feature_dim)
    assert (np.abs(allx).sum(axis=1) > 0).all()


def test_homo_ratio_no_labeled_edges():
    adj = sp.csr_matrix(np.array([[0, 1], [1, 0]], dtype=np.float32))
    out = graph_stats.getHomoEdgeRatio(adj, np.zeros(2, dtype=np.int64))
    assert out["homoEdgeRatio"] == 0.0


def test_homo_ratio_counts_self_loops():
    adj = sp.csr_matrix(np.array([[1, 1], [1, 0]], dtype=np.float32))
    out = graph_stats.getHomoEdgeRatio(adj, np.array([1, 2], dtype=np.int64))
    assert out["homoEdgeRatio"] == 0.5


def test_save_y_unlabeled_node_warns_not_crashes(tmp_path, capsys):
    GraphGenerator(2).save_y({0: [1], 1: [0], 2: []}, np.array([1, 2, 0]),
                             str(tmp_path), "g")
    with open(tmp_path / "g.ally", "rb") as f:
        ally = pickle.load(f)
    assert np.all(ally[2] == 0) and ally[0, 0] == 1 and ally[1, 1] == 1
    assert "valid label" in capsys.readouterr().out


def test_generate_split_insufficient_validation_returns_none(tmp_path):
    ally = np.zeros((8, 2))
    ally[:4, 0] = 1
    ally[4:, 1] = 1
    adj_lists = {i: [(i + 1) % 8] for i in range(8)}
    out = fg.generate_split(adj_lists, ally, ally.copy(), "2c_3c_2c",
                            str(tmp_path), "g", rng=np.random.RandomState(0))
    assert out is None


def test_generate_split_with_given_indices(tmp_path):
    ally = np.zeros((9, 3))
    for c in range(3):
        ally[3 * c: 3 * (c + 1), c] = 1
    allx = np.arange(9, dtype=float)[:, None] * np.ones((9, 4))
    adj_lists = {i: [(i + 1) % 9] for i in range(9)}
    te = np.array([2, 5, 8])
    out = fg.generate_split(adj_lists, ally, allx, "", str(tmp_path), "g",
                            rng=np.random.RandomState(0),
                            train_indices=np.array([0, 3, 6]),
                            test_indices=te,
                            validation_indices=np.array([1, 4, 7]))
    assert out is not None and out["val_size"] == 3
    with open(tmp_path / "g.ty", "rb") as f:
        assert np.array_equal(pickle.load(f), ally[te])
    assert sorted(out["node_mapping"].values()) == list(range(9))


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("ratio,h", [
    ([40, 40, 40], 0.0), ([40, 40, 40], 0.5), ([40, 40, 40], 1.0),
    ([3, 2, 1], 0.3), ([3, 2, 1], 0.7)])
def test_generator_matches_jax_bit_for_bit(ratio, h):
    # sizes summing to n shuffle a color sequence, a ratio draws each
    # color; h 0 and 1 take the weighted seed phase, the others the chain
    # (a drawn color may have no earlier node of its class: pure homophily
    # then has nothing to attach to, in both packages)
    out = []
    for mod in (j_gen, t_gen):
        gen = mod.MixhopGraphGenerator(ratio, rng=np.random.RandomState(5))
        out.append(gen(120, 2, 6, h=h))
    (j_adj, j_colors), (t_adj, t_colors) = out
    assert t_adj == j_adj
    np.testing.assert_array_equal(t_colors, j_colors)
    assert t_colors.dtype == j_colors.dtype


def test_statistics_match_jax(syn_graph):
    _, adj_lists, colors = syn_graph
    A = adj_lists_to_scipy(adj_lists)
    ally = _ally(colors, 3)
    sp_ = dict(method="mixhop", classRatio=[100, 100, 100], h=0.8,
               heteroWeightsExponent=1.0)
    ours = graph_stats.calculate_statistics(A, colors, ally, statepoint=sp_)
    ref = j_stats.calculate_statistics(A, colors, ally, statepoint=sp_)
    assert set(ours) == set(ref) == set(graph_stats.stats_dict)
    for key in ref:
        o, r = np.asarray(ours[key]), np.asarray(ref[key])
        assert o.shape == r.shape and o.dtype == r.dtype, key
        np.testing.assert_allclose(o, r, rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=key)


def test_row_sample_matches_jax(planetoid_source):
    from h2gcn_tpu.datasets._dataset import PlanetoidData as JPlanetoid
    from h2gcn_tpu_torch.datasets._dataset import PlanetoidData

    ally = np.zeros((90, 3))
    ally[np.arange(90), np.arange(90) % 3] = 1
    ours = fg.row_sample(ally, PlanetoidData("ind.syncora", planetoid_source,
                                             val_size=None),
                         rng=np.random.RandomState(4))
    ref = j_fg.row_sample(ally, JPlanetoid("ind.syncora", planetoid_source,
                                           val_size=None),
                          rng=np.random.RandomState(4))
    np.testing.assert_array_equal(ours, ref)


def test_split_files_match_jax_byte_for_byte(tmp_path, syn_graph):
    _, adj_lists, colors = syn_graph
    ally = _ally(colors, 3)
    allx = np.random.RandomState(7).rand(len(colors), 12)
    sp_ = {"split_config": "0.25p__0.5p", "split_index": 0}
    name = "syn-naive-0.25p__0.5p"
    jobs, results = [], []
    for tag, store, mod in (("jax", j_store, j_fg), ("torch", t_store, fg)):
        job = store.get_project(str(tmp_path / tag)).open_job(sp_).init()
        results.append(mod.generate_split(
            adj_lists, ally, allx, "0.25p__0.5p", job.workspace(), name,
            rng=np.random.RandomState(11)))
        jobs.append(job)
    (j_job, t_job), (j_res, t_res) = jobs, results
    assert t_job.id == j_job.id
    assert t_res["files"] == j_res["files"]
    assert t_res["node_mapping"] == j_res["node_mapping"]
    assert t_res["val_size"] == j_res["val_size"]
    for fn in t_res["files"] + ["node_mapping.json"]:
        with open(t_job.fn(fn), "rb") as a, open(j_job.fn(fn), "rb") as b:
            assert a.read() == b.read(), fn
    md5 = workflow.split_files_md5(t_job, t_res["files"])
    assert md5 == j_workflow.split_files_md5(j_job, j_res["files"])
    assert len(md5.split("_")) == 8


def test_ogbn_transplant_needs_ogb(tmp_path):
    # the port downloads nothing: without ogb it raises a clear error
    try:
        import ogb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="'ogb' package"):
            fg.ogbn_transplant_features(tmp_path, "x", tmp_path, "y")
    else:
        pytest.skip("ogb is installed: its dataset would be read from disk")

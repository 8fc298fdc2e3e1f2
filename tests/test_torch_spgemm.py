"""The port's row-sharded exact-hop precompute (``h2gcn_tpu_torch.parallel.
spgemm``, ``--precompute_workers``) against the single-worker split and
against the JAX package's.

Twins of ``tests/test_dist_spgemm.py``: the sharded algorithm equals
``transforms.nhood_split`` entry for entry (the same CSR patterns), for
any worker count and either transport. Parity: the same splits and the
same measured halo volumes (``SpgemmStats``) as the JAX package's
``dist_nhood_split``; ``get_tensors(precompute_workers=3)`` and the CLI's
``--precompute_workers 2`` give the tensors and first-epoch loss of one
worker, exactly (the same matrices go through the same arithmetic).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from h2gcn_tpu.parallel import spgemm as j_spgemm
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.datasets._dataset import PlanetoidData
from h2gcn_tpu_torch.parallel.spgemm import SpgemmStats, dist_nhood_split
from h2gcn_tpu_torch.sparse import transforms


def _rand_graph(n, m, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    r = np.concatenate([src[keep], dst[keep]])
    c = np.concatenate([dst[keep], src[keep]])
    a = sp.csr_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o = o.tocsr().sorted_indices()
        r = r.tocsr().sorted_indices()
        r.eliminate_zeros()
        np.testing.assert_array_equal(o.indptr, r.indptr)
        np.testing.assert_array_equal(o.indices, r.indices)


# ------------------------------------------------ twins of test_dist_spgemm
@pytest.mark.parametrize("nhood", [1, 2, 3])
def test_sharded_algorithm_matches_nhood_split(nhood):
    a = _rand_graph(300, 900, seed=nhood)
    _assert_same(dist_nhood_split(a, nhood, n_workers=1),
                 transforms.nhood_split(a, nhood))


def test_early_termination_on_saturated_graph():
    a = _rand_graph(40, 400, seed=7)
    _assert_same(dist_nhood_split(a, 6, n_workers=1),
                 transforms.nhood_split(a, 6))


def test_multiprocess_workers_match_and_report_stats():
    a = _rand_graph(500, 1500, seed=3)
    ref = transforms.nhood_split(a, 2)
    ours, stats = dist_nhood_split(a, 2, n_workers=3, return_stats=True)
    _assert_same(ours, ref)
    assert stats.n_workers == 3
    assert stats.rounds == 1
    assert len(stats.halo_rows[0]) == 3
    assert all(h > 0 for h in stats.halo_rows[0])
    assert stats.total_halo_bytes > 0
    assert sum(stats.shard_nnz[1]) == ref[2].nnz


def test_uneven_shards_and_isolated_nodes():
    a = _rand_graph(101, 150, seed=11)
    _assert_same(dist_nhood_split(a, 2, n_workers=4),
                 transforms.nhood_split(a, 2))


def test_edgeless_graph_matches_nhood_split():
    a = sp.csr_matrix((50, 50), dtype=np.float32)
    _assert_same(dist_nhood_split(a, 2, n_workers=1),
                 transforms.nhood_split(a, 2))


def test_transports_agree_and_report_stats():
    a = _rand_graph(120, 600, seed=5)
    ref = transforms.nhood_split(a, 3)
    thr, s_thr = dist_nhood_split(a, 3, n_workers=2, return_stats=True,
                                  transport="threads")
    prc, s_prc = dist_nhood_split(a, 3, n_workers=2, return_stats=True,
                                  transport="processes")
    _assert_same(thr, ref)
    _assert_same(prc, ref)
    assert s_thr.rounds == s_prc.rounds
    assert s_thr.halo_rows == s_prc.halo_rows
    assert s_thr.total_halo_bytes > 0


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("transport", ["threads", "processes"])
def test_dist_nhood_split_matches_jax(transport):
    a = _rand_graph(400, 1200, seed=13)
    ours, s_ours = dist_nhood_split(a, 3, n_workers=3, return_stats=True,
                                    transport=transport)
    ref, s_ref = j_spgemm.dist_nhood_split(a, 3, n_workers=3,
                                           return_stats=True,
                                           transport=transport)
    _assert_same(ours, ref)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
    assert ([f.name for f in dataclasses.fields(SpgemmStats)]
            == [f.name for f in dataclasses.fields(j_spgemm.SpgemmStats)])
    assert dataclasses.asdict(s_ours) == dataclasses.asdict(s_ref)
    assert s_ours.total_halo_bytes == s_ref.total_halo_bytes


@pytest.mark.parametrize("workers", [2, 5])
def test_nhood_split_workers_match_one(workers):
    a = _rand_graph(257, 700, seed=workers)
    _assert_same(transforms.nhood_split(a, 3, n_workers=workers),
                 transforms.nhood_split(a, 3))


@pytest.fixture(scope="module")
def planetoid(tmp_path_factory):
    path = tmp_path_factory.mktemp("spgemm")
    chip_smoke.write_planetoid(
        str(path), "syn", chip_smoke.build_graph(n=300, m_edges=900, seed=2),
        seed=2, n_feat=40, feats_per_row=4, n_classes=3, train_per_class=10,
        n_test=60)
    return str(path)


def test_get_tensors_three_workers_match_one(planetoid):
    tensors = []
    for workers in (1, 3):
        ds = PlanetoidData("ind.syn", planetoid)
        ds.adj_remove_eye()
        tensors.append(ds.get_tensors(get_adj_norm_hops=["1", "2"],
                                      backend="segment",
                                      precompute_workers=workers))
    one, three = tensors
    assert len(one.adj_hops) == len(three.adj_hops) == 2
    for h1, h3 in zip(one.adj_hops, three.adj_hops):
        a, b = h1.to_scipy().tocsr(), h3.to_scipy().tocsr()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)


def test_cli_precompute_workers_match_one(planetoid, tmp_path):
    runs = []
    for workers in (1, 2):
        args = run_experiments.main([
            "H2GCN", "planetoid", "--dataset", "ind.syn", "--dataset_path",
            planetoid, "--device", "cpu", "--epochs", "1",
            "--precompute_workers", str(workers), "--checkpoint_dir",
            str(tmp_path / f"ck{workers}")])
        assert args.precompute_workers == workers
        runs.append(args)
    one, two = (a.objects["tensors"] for a in runs)
    for h1, h2 in zip(one["adj_hops"], two["adj_hops"]):
        torch.testing.assert_close(h2.todense(), h1.todense(), rtol=0,
                                   atol=0)
    torch.testing.assert_close(two["features"], one["features"], rtol=0,
                               atol=0)
    loss = [float(a.objects["epoch_stats"]["train_loss"]) for a in runs]
    assert np.isfinite(loss[0]) and loss[1] == loss[0]

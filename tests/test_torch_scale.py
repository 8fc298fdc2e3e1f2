"""The at-scale H2GCN path of the PyTorch port against the JAX package:
native host kernels, cluster reordering, sparse features and the COO-tile
backend.

The native library, ``cluster_order`` and ``permute_graph`` must give the
JAX package's results exactly (the same permutation, the same matrices), and
so must ``get_tensors(reorder="cluster", sparse_features=True)``. H2GCN-2
with the JAX package's parameters, dropout-free, on the cootile path with
the cluster reorder and sparse features must give the JAX logits and losses
at the tolerance of ``tests/test_torch_slice.py`` (rtol 2e-5, atol 2e-6),
also after a training step, and its logits in the original node order must
be those of the un-reordered graph.
"""

import glob
import shutil
from argparse import Namespace
from collections import deque

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from h2gcn_tpu import native as jnative
from h2gcn_tpu.datasets._dataset import PlanetoidData as JPlanetoidData
from h2gcn_tpu.models import _runtime as j_runtime
from h2gcn_tpu.nn import NetworkModel as JNetworkModel
from h2gcn_tpu.nn import parse_network_setup as j_parse
from h2gcn_tpu.sparse import transforms as jt
from h2gcn_tpu_torch import native as tnative
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.datasets._dataset import PlanetoidData
from h2gcn_tpu_torch.models import _runtime as t_runtime
from h2gcn_tpu_torch.nn import NetworkModel, load_jax_params, parse_network_setup
from h2gcn_tpu_torch.nn.ops import dropout
from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
from h2gcn_tpu_torch.sparse import transforms as tt

NAME = "synscale"
SETUP = "M64-R-T1-G-V-T2-G-V-C1-C2-MO"  # H2GCN-2 without dropout


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable, so "
                    "its reference order is scipy's")
    assert tnative.available(), "the port's native library did not build"


def _same(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype and a.nnz == b.nnz
    assert (a != b).nnz == 0


def _zipf_graph(n=1500, m=5000, seed=0):
    return chip_smoke.build_graph(n=n, m_edges=m, seed=seed, skew=0.8)


def test_native_kernels_match_jax(jax_native):
    a = _zipf_graph()
    b = _zipf_graph(seed=1)
    _same(tnative.bool_spgemm(a, b), jnative.bool_spgemm(a, b))
    _same(tnative.bool_subtract(a, b), jnative.bool_subtract(a, b))
    np.testing.assert_array_equal(tnative.rcm_order(a), jnative.rcm_order(a))
    ours = tnative.nhood_split_fast(a, 3)
    ref = jnative.nhood_split_fast(a, 3)
    assert len(ours) == len(ref) == 4
    for x, y in zip(ours, ref):
        _same(x, y)
    # nhood_split routes to the native path by default, as in JAX
    for x, y in zip(tt.nhood_split(a, 2), jt.nhood_split(a, 2)):
        _same(x, y)


def test_native_builds_serial_without_openmp(jax_native, tmp_path,
                                             monkeypatch):
    """A host compiler without an OpenMP runtime still builds the library,
    serial, with the same results."""
    real = shutil.which("g++")
    if real is None:
        pytest.skip("no g++ to wrap")
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\n"
                    'for a in "$@"; do [ "$a" = -fopenmp ] && exit 1; done\n'
                    f'exec {real} "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(tnative, "_compilers", lambda: [str(fake)])
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "libgraphops_serial.so")
    tnative._load.cache_clear()
    try:
        assert tnative.available() and tnative.openmp_threads() == 1
        a = _zipf_graph(seed=3)
        np.testing.assert_array_equal(tnative.rcm_order(a),
                                      jnative.rcm_order(a))
        for x, y in zip(tnative.nhood_split_fast(a, 2),
                        jnative.nhood_split_fast(a, 2)):
            _same(x, y)
    finally:
        tnative._load.cache_clear()


@pytest.mark.parametrize("method", ["cluster", "rcm"])
def test_cluster_order_and_permute_graph_match_jax(jax_native, method):
    a = _zipf_graph(seed=2)
    pattern = abs(a) + abs(tt.nhood_split(a, 2)[2])
    perm = tt.cluster_order(pattern, method=method)
    ref = jt.cluster_order(pattern, method=method)
    assert perm.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(perm, ref)
    assert sorted(perm.tolist()) == list(range(a.shape[0]))
    _same(tt.permute_graph(a, perm), jt.permute_graph(a, ref))
    if method == "cluster":
        # the hubs come first, by descending degree
        deg = np.diff(sp.csr_matrix(pattern).indptr)
        assert deg[perm[0]] == deg.max()
    with pytest.raises(ValueError, match="reorder"):
        tt.cluster_order(pattern, method="metis")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=900, m_edges=2700, seed=4, skew=0.8)
    chip_smoke.write_planetoid(path, NAME, adj, seed=4, n_feat=300,
                               feats_per_row=6, n_test=200)
    return path


def _datasets(data_dir):
    out = []
    for cls in (JPlanetoidData, PlanetoidData):
        ds = cls(f"ind.{NAME}", data_dir, val_size=500)
        ds.row_normalize_features()
        ds.adj_remove_eye()
        out.append(ds)
    return out


def _tensors(jds, tds, **kw):
    # the JAX package's cootile backend runs its segment path on the CPU
    jt_ = jds.get_tensors(get_adj_norm_hops=["1", "2"], backend="segment",
                          **kw)
    tt_ = tds.get_tensors(get_adj_norm_hops=["1", "2"], backend="cootile",
                          **kw)
    return jt_, tt_


def test_get_tensors_reorder_sparse_features_match_jax(jax_native, data_dir):
    jds, tds = _datasets(data_dir)
    jten, tten = _tensors(jds, tds, reorder="cluster", sparse_features=True)
    np.testing.assert_array_equal(tten.node_perm, jten.node_perm)
    assert not np.array_equal(tten.node_perm, np.arange(900))
    for a, b in zip(tten.adj_hops + [tten.adj], jten.adj_hops + [jten.adj]):
        assert a.backend == "cootile" and a.nnz == b.nnz
        _same(a.to_scipy(), b.to_scipy())
    f, jf = tten.features, jten.features
    assert isinstance(f, SparseMatrix) and f.backend == "segment"
    assert f.shape == jf.shape and f.nnz == jf.nnz
    for key in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(f, key).numpy(),
                                      np.asarray(getattr(jf, key)),
                                      err_msg=key)
    for key in ("y_train", "y_val", "y_test", "train_mask", "val_mask",
                "test_mask", "labels"):
        np.testing.assert_array_equal(getattr(tten, key).numpy(),
                                      np.asarray(getattr(jten, key)),
                                      err_msg=key)


def _args(ds, tensors):
    return Namespace(
        objects={"dataset": ds, "tensors": vars(tensors),
                 "post_epoch_callbacks": deque(),
                 "post_train_callbacks": deque()},
        random_seed=123, grad_monitor=False, verbose=False, use_signac=False,
        deg_acc_monitor=[], best_val_criteria="val_acc", current_epoch=0)


def test_h2gcn_on_the_scale_path_matches_jax(jax_native, data_dir):
    jds, tds = _datasets(data_dir)
    jten, tten = _tensors(jds, tds, reorder="cluster", sparse_features=True)
    n_labels = jds.num_labels
    jargs = _args(jds, jten)
    j_runtime.initialize_model(jargs, JNetworkModel(
        j_parse(SETUP, n_labels), l2_regularize_weight=5e-4), "adam", 0.01, 0)
    targs = _args(tds, tten)
    model = NetworkModel(parse_network_setup(SETUP, n_labels),
                         l2_regularize_weight=5e-4)
    t_runtime.initialize_model(targs, model, "adam", 0.01, 0)
    load_jax_params(model, [{k: np.asarray(v) for k, v in p.items()}
                            for p in jargs.objects["state"]["params"]])

    def logits(args):
        return np.asarray(args.objects["predict_step"](
            **args.objects["tensors"]))

    tol = dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(logits(targs), logits(jargs), **tol)
    losses = []
    for _ in range(2):
        losses.append([float(a.objects["train_step"](
            **a.objects["tensors"])["train_loss"]) for a in (targs, jargs)])
    t_loss, j_loss = np.array(losses).T
    np.testing.assert_allclose(t_loss, j_loss, **tol)
    np.testing.assert_allclose(logits(targs), logits(jargs), **tol)
    t_stats = targs.objects["test_step"](**targs.objects["tensors"])
    j_stats = jargs.objects["test_step"](**jargs.objects["tensors"])
    for key in ("val_loss", "test_loss", "val_acc", "test_accuracy"):
        np.testing.assert_allclose(float(t_stats[key]), float(j_stats[key]),
                                   err_msg=key, **tol)

    # in the original node order: the logits of the un-reordered graph
    # (dense features, segment SpMM) under the same weights
    plain = PlanetoidData(f"ind.{NAME}", data_dir, val_size=500)
    plain.row_normalize_features()
    plain.adj_remove_eye()
    p = plain.get_tensors(get_adj_norm_hops=["1", "2"], backend="segment")
    with torch.no_grad():
        ref = model(p.adj, p.features, p.adj_hops)
    got = targs.objects["original_order"](
        targs.objects["predict_step"](**targs.objects["tensors"]))
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)


def test_sparse_dropout_masks_the_stored_values():
    x = sp.random(64, 32, density=0.3, format="csr", dtype=np.float32,
                  random_state=0)
    x.data[:] = 1.0
    sm = SparseMatrix.from_scipy(x, backend="segment")
    gen = torch.Generator().manual_seed(0)
    out = dropout(sm, 0.5, gen, training=True)
    assert isinstance(out, SparseMatrix)
    # the pattern stays; kept values are rescaled by 1/keep, dropped are 0
    assert torch.equal(out.rows, sm.rows) and torch.equal(out.cols, sm.cols)
    vals = out.vals[:sm.nnz].numpy()
    assert set(np.unique(vals)) == {0.0, 2.0}
    assert 0.3 < (vals == 2.0).mean() < 0.7
    assert not out.vals[sm.nnz:].any()  # padding stays 0
    # the SpMM reads the dropped values
    w = torch.ones(32, 1)
    np.testing.assert_allclose(spmm(out, w).numpy(),
                               out.to_scipy() @ w.numpy(), rtol=1e-6)
    assert dropout(sm, 0.5, gen, training=False) is sm
    for backend in ("cootile", "gscatter", "dense"):
        other = SparseMatrix.from_scipy(x, backend=backend)
        with pytest.raises(ValueError, match="segment"):
            dropout(other, 0.5, gen, training=True)


def test_cli_trains_on_the_scale_path(data_dir, tmp_path):
    args = run_experiments.main(
        ["H2GCN", "planetoid", "--dataset", f"ind.{NAME}", "--dataset_path",
         data_dir, "--device", "cpu", "--sparse_backend", "cootile",
         "--reorder", "cluster", "--sparse_features", "--epochs", "2",
         "--checkpoint_dir", str(tmp_path)])
    tensors = args.objects["tensors"]
    assert isinstance(tensors["features"], SparseMatrix)
    assert all(h.backend == "cootile" for h in tensors["adj_hops"])
    assert sorted(tensors["node_perm"].tolist()) == list(range(900))
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(float(args.objects["epoch_stats"][key]))
    assert glob.glob(str(tmp_path / "*" / "ckpt.pt"))

"""The baselines of the PyTorch port (GCN family, belief propagation,
MixHop, GraphSAGE) against the JAX package on the CPU.

One small synthetic planetoid directory (chip_smoke.py's writer, 240
nodes, 48 features) feeds both packages. Held here:
- the Chebyshev supports (fixed eigenvalue and ARPACK, and ARPACK's
  fallback), ``get_tensors``' explicit supports, unnormalized dense hop
  stack and CHEBY hop groups: exact nnz, values to 1e-7;
- ``build_ell``: exactly equal;
- every model's forward and loss with the JAX weights carried over, at
  rtol 1e-5 / atol 1e-6, GCN's also through the plain versions of the SpMM
  kernels (gscatter, BSR, COO-tile) on self-looped and Chebyshev supports;
- 10 dropout-free train steps through both runtimes at rtol 2e-5 / atol
  2e-6: Adam for GCN, scheduled SGD for MixHop, SGD for GraphSAGE;
- the optimizers against optax for 10 steps, parameters at 1e-6;
- ``AdjacencyPowersParser`` on the JAX package's specs;
- a 3-epoch CLI run of each model on ``--device cpu``.
"""

import glob
import json
from argparse import Namespace
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from h2gcn_tpu import native as j_native
from h2gcn_tpu.datasets._dataset import PlanetoidData as JPlanetoidData
from h2gcn_tpu.models import GCN as jgcn
from h2gcn_tpu.models import GRAPHSAGE as jsage
from h2gcn_tpu.models import MIXHOP as jmix
from h2gcn_tpu.models import _runtime as j_runtime
from h2gcn_tpu.modules.controller import PatienceEarlyStopping as JPatience
from h2gcn_tpu.nn import NetworkModel as JNetworkModel
from h2gcn_tpu.sparse import transforms as jt
from h2gcn_tpu_torch import native as t_native
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.datasets._dataset import PlanetoidData
from h2gcn_tpu_torch.models import GCN as tgcn
from h2gcn_tpu_torch.models import GRAPHSAGE as tsage
from h2gcn_tpu_torch.models import MIXHOP as tmix
from h2gcn_tpu_torch.models import _runtime as t_runtime
from h2gcn_tpu_torch.modules.controller import PatienceEarlyStopping
from h2gcn_tpu_torch.nn import NetworkModel, load_jax_params
from h2gcn_tpu_torch.sparse import transforms as tt

NAME = "synb"
FWD = dict(rtol=1e-5, atol=1e-6)
STEPS = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid_baselines"))
    adj = chip_smoke.build_graph(n=240, m_edges=700, seed=5)
    chip_smoke.write_planetoid(path, NAME, adj, seed=5, n_feat=48,
                               feats_per_row=5, train_per_class=5, n_test=60)
    return path


def _datasets(data_dir, features="row"):
    out = []
    for cls in (JPlanetoidData, PlanetoidData):
        ds = cls(f"ind.{NAME}", data_dir, val_size=60)
        if features == "row":
            ds.row_normalize_features()
        elif features == "labels":
            ds.set_label_one_hot_features()
        out.append(ds)
    return out


def _same_sparse(a, b, tol=1e-7):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    assert a.nnz == b.nnz
    diff = abs(a - b)
    assert diff.nnz == 0 or diff.max() <= tol


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


# ------------------------------------------------------------ host supports
@pytest.mark.parametrize("k,eigenvalue", [(3, 2), (2, 1.5), (3, None)])
def test_chebyshev_polynomials_match_jax(data_dir, k, eigenvalue):
    jds, _ = _datasets(data_dir, features=None)
    adj = jds.sparse_adj
    ours = tt.chebyshev_polynomials(adj, k, eigenvalue=eigenvalue)
    ref = jt.chebyshev_polynomials(adj, k, eigenvalue=eigenvalue)
    assert len(ours) == len(ref) == k + 1
    for a, b in zip(ours, ref):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.nnz == b.nnz  # explicit zeros included
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.data, b.data, rtol=0, atol=1e-7)
    # the supports hold negative values (T_1 = -D^-1/2 A D^-1/2 at λ = 2)
    assert (sp.csr_matrix(ours[1]).data < 0).any()


def test_chebyshev_arpack_fallback_warns_and_takes_two(monkeypatch):
    import scipy.sparse.linalg as spla

    def no_convergence(*a, **kw):
        raise spla.ArpackNoConvergence("no convergence", np.array([]),
                                       np.array([]))

    adj = chip_smoke.build_graph(n=60, m_edges=150, seed=2)
    monkeypatch.setattr(spla, "eigsh", no_convergence)
    with pytest.warns(UserWarning, match="ARPACK did not converge"):
        ours = tt.chebyshev_polynomials(adj, 2)
    ref = jt.chebyshev_polynomials(adj, 2, eigenvalue=2)
    for a, b in zip(ours, ref):
        _same_sparse(a, b)


@pytest.mark.parametrize("case", ["supports", "supports_reorder",
                                  "adj_hops", "cheby_groups"])
def test_get_tensors_match_jax(data_dir, case):
    jds, tds = _datasets(data_dir)
    if case.startswith("supports"):
        kwargs = [dict(supports=[jt.normalize(jt.add_eye(jds.sparse_adj))]
                       + jt.chebyshev_polynomials(jds.sparse_adj, 2, 2)),
                  dict(supports=[tt.normalize(tt.add_eye(tds.sparse_adj))]
                       + tt.chebyshev_polynomials(tds.sparse_adj, 2, 2))]
        if case.endswith("reorder"):
            for kw in kwargs:
                kw["reorder"] = "rcm"
    elif case == "adj_hops":
        kwargs = [dict(get_adj_hops=["1", "0,2"])] * 2
    else:
        kwargs = [dict(get_adj_norm_hops=["0,1", "2", "3"],
                       norm_type=jt.NType.CHEBY),
                  dict(get_adj_norm_hops=["0,1", "2", "3"],
                       norm_type=tt.NType.CHEBY)]
    jten = jds.get_tensors(backend="segment", **kwargs[0])
    tten = tds.get_tensors(backend="segment", **kwargs[1])
    if case == "adj_hops":
        assert tuple(tten.adj_hops.shape) == (240, 2, 240)
        np.testing.assert_array_equal(_np(tten.adj_hops),
                                      np.asarray(jten.adj_hops))
    else:
        assert len(tten.adj_hops) == len(jten.adj_hops)
        for a, b in zip(tten.adj_hops, jten.adj_hops):
            assert a.nnz == b.nnz
            _same_sparse(a.to_scipy(), b.to_scipy())
    if case == "supports_reorder":
        np.testing.assert_array_equal(tten.node_perm, jten.node_perm)
    for key in ("features", "y_train", "train_mask", "labels"):
        np.testing.assert_array_equal(_np(getattr(tten, key)),
                                      np.asarray(getattr(jten, key)))


def test_get_adj_hops_refuses_past_the_dense_guard(data_dir, monkeypatch):
    _, tds = _datasets(data_dir)
    monkeypatch.setattr(PlanetoidData, "_DENSE_FEATURE_GUARD", 1000)
    with pytest.raises(ValueError, match="dense"):
        tds.get_tensors(get_adj_hops=["1"])


@pytest.mark.parametrize("seed,density", [(0, 0.05), (1, 0.2)])
def test_build_ell_matches_jax(seed, density):
    A = sp.random(90, 90, density=density, random_state=seed, format="csr")
    A = A.tolil()
    A[4, :] = 0  # an empty row
    A = A.tocsr()
    table, valid = t_native.build_ell(A)
    j_table, j_valid = j_native.build_ell(A)
    assert table.dtype == np.int32 and valid.dtype == bool
    np.testing.assert_array_equal(table, j_table)
    np.testing.assert_array_equal(valid, j_valid)


def test_build_ell_without_the_library_is_the_same(monkeypatch):
    A = sp.random(70, 70, density=0.1, random_state=3, format="csr")
    want = t_native.build_ell(A)
    monkeypatch.setattr(t_native, "_load", lambda: None)
    got = t_native.build_ell(A)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ models
def _gcn_supports(pkg, ds, variant):
    if variant in ("cheby", "cheby_concat2"):
        return pkg.chebyshev_polynomials(ds.sparse_adj, 3, eigenvalue=2)
    if variant == "mlp":
        return []
    if variant == "bp":
        return [pkg.normalize(ds.sparse_adj, pkg.NType.RW_NORMALIZED)]
    return [pkg.normalize(pkg.add_eye(ds.sparse_adj),
                          pkg.NType.SYM_NORMALIZED)]


def _gcn_pair(data_dir, variant, backend="segment"):
    jds, tds = _datasets(data_dir,
                         features="labels" if variant == "bp" else "row")
    jten = jds.get_tensors(supports=_gcn_supports(jt, jds, variant),
                           backend="segment")
    tten = tds.get_tensors(supports=_gcn_supports(tt, tds, variant),
                           backend=backend)
    nl = jds.num_labels
    n_hops = max(1, len(jten.adj_hops))
    if variant == "bp":
        jmodel = jgcn.BeliefPropagationNetwork(nl)
        tmodel = tgcn.BeliefPropagationNetwork(nl)
        jparams = jmodel.init(jax.random.PRNGKey(0), jds.feature_dim)
        tmodel.init(tds.feature_dim, n_hops, torch.Generator())
        return jten, tten, jmodel, jparams, tmodel
    setups = jgcn.build_layer_setups(variant, 16, 0.0, nl)
    jmodel = JNetworkModel(setups, l2_regularize_weight=5e-4)
    jparams = jmodel.init(jax.random.PRNGKey(3), jds.feature_dim, n_hops)
    tmodel = NetworkModel(tgcn.build_layer_setups(variant, 16, 0.0, nl),
                          l2_regularize_weight=5e-4)
    tmodel.init(tds.feature_dim, n_hops, torch.Generator().manual_seed(0))
    load_jax_params(tmodel, [{k: np.asarray(v) for k, v in p.items()}
                             for p in jparams])
    return jten, tten, jmodel, jparams, tmodel


def _check_forward(pair):
    jten, tten, jmodel, jparams, tmodel = pair
    jlogits = jmodel.apply(jparams, jten.adj, jten.features, jten.adj_hops)
    jloss = jmodel.loss(jparams, jlogits, jten.y_train, jten.train_mask)
    with torch.no_grad():
        tlogits = tmodel(tten.adj, tten.features, tten.adj_hops)
        tloss = tmodel.loss(tlogits, tten.y_train, tten.train_mask)
    assert np.isfinite(_np(tlogits)).all()
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **FWD)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)


@pytest.mark.parametrize("variant,backend", [
    ("gcn", "segment"), ("gcn", "gscatter"), ("gcn", "bsr"),
    ("gcn", "cootile"), ("cheby", "segment"), ("cheby", "gscatter"),
    ("cheby", "bsr"), ("cheby", "cootile"), ("concat2", "segment"),
    ("cheby_concat2", "segment"), ("mlp", "segment"), ("bp", "segment"),
    ("bp", "gscatter"),
])
def test_gcn_family_forward_matches_jax(data_dir, variant, backend):
    _check_forward(_gcn_pair(data_dir, variant, backend))


MIXHOP_SPECS = {
    # layer 1 projects first (48 > 4 * 8), layer 2 chains, power 0 with
    # capacity 0 at the output
    "project_then_chain": ("0:2:0,1:3:7,2:3:7", "8"),
    # the published Cora setup: layer 1 chains (48 <= 4 * 60), layer 2
    # projects first (60 > 4 * 14)
    "published": ("0:24:0,1:18:7,2:18:7", "60"),
    "no_colon": ("0,1,2", "21"),
}


def _mixhop_models(spec, num_classes, **kw):
    parser = jmix.AdjacencyPowersParser(spec[0])
    dims = [int(d) for d in spec[1].split(",")]
    dims.append(parser.output_capacity(num_classes))
    caps = [parser.divide_capacity(j, d) for j, d in enumerate(dims)]
    kw = dict(dict(input_dropout=0.0, layer_dropout=0.0), **kw)
    return (jmix.MixHopNetwork(parser.powers(), caps, num_classes, **kw),
            tmix.MixHopNetwork(parser.powers(), caps, num_classes, **kw))


def _mixhop_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _mixhop_pair(data_dir, spec, **kw):
    jds, tds = _datasets(data_dir)
    jten = jds.get_tensors(supports=[jt.normalize(jt.add_eye(
        jds.sparse_adj))], backend="segment")
    tten = tds.get_tensors(supports=[tt.normalize(tt.add_eye(
        tds.sparse_adj))], backend="segment")
    jmodel, tmodel = _mixhop_models(MIXHOP_SPECS[spec], jds.num_labels, **kw)
    jparams = jmodel.init(jax.random.PRNGKey(4), jds.feature_dim)
    # nonzero betas and segment weights, so both reach the output
    jparams["psum_q"] = jnp.linspace(-0.5, 0.5, jparams["psum_q"].shape[0])
    for bn in jparams["bn"]:
        if "beta" in bn:
            bn["beta"] = jnp.linspace(-0.2, 0.3, bn["beta"].shape[0])
    tmodel.init(tds.feature_dim, 1, torch.Generator().manual_seed(0))
    tmix.load_jax_mixhop_params(tmodel, _mixhop_np(jparams))
    return jten, tten, jmodel, jparams, tmodel


@pytest.mark.parametrize("spec", sorted(MIXHOP_SPECS))
def test_mixhop_forward_matches_jax(data_dir, spec):
    pair = _mixhop_pair(data_dir, spec)
    _check_forward(pair)
    tmodel = pair[4]
    if spec != "no_colon":
        assert tuple(tmodel.kernels[-1]["0"].shape) == (
            sum(tmodel.layer_capacities[-2]), 0)


def test_mixhop_paths_and_batch_norm(data_dir):
    """Which layers project first, and batch norm from the batch's own
    statistics in evaluation too (no running statistics)."""
    _, tten, _, _, tmodel = _mixhop_pair(data_dir, "project_then_chain")
    calls = []
    orig = tmix.spmm
    try:
        tmix.spmm = lambda a, x: calls.append(x.shape[1]) or orig(a, x)
        with torch.no_grad():
            tmodel(tten.adj, tten.features, tten.adj_hops)
    finally:
        tmix.spmm = orig
    # layer 1 aggregates each power's projection (3 + 3 + 3 columns), layer
    # 2 chains the 8-wide input twice
    assert calls == [3, 3, 3, 8, 8]
    with torch.no_grad():
        a = tmodel(tten.adj, tten.features, tten.adj_hops)
        b = tmodel(tten.adj, tten.features * 3.0, tten.adj_hops)
    # row L2 normalisation makes the input scale irrelevant
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_mixhop_params_load_checks_shapes(data_dir):
    jten, tten, jmodel, jparams, tmodel = _mixhop_pair(data_dir, "published")
    bad = _mixhop_np(jparams)
    bad["layers"][0]["1"] = bad["layers"][0]["1"][:, :3]
    with pytest.raises(ValueError):
        tmix.load_jax_mixhop_params(tmodel, bad)


SAGE_CASES = {
    "plain_ell": dict(),
    "plain_spmm": dict(spmm=True),
    "concat_ell": dict(concat_jk=True),
    "gcn_aggregator_spmm": dict(gcn_aggregator=True, spmm=True),
    "gcn_encoder_ell": dict(gcn_encoder=True),
}


def _sage_pair(data_dir, case, backend="segment"):
    kw = dict(SAGE_CASES[case])
    use_spmm = kw.pop("spmm", False)
    jds, tds = _datasets(data_dir, features=None)
    jten = jds.get_tensors(backend="segment")
    tten = tds.get_tensors(backend="segment")
    csr = jds.sparse_adj.tocsr()
    jtab, jval = jsage.build_neighbor_table(csr)
    ttab, tval = tsage.build_neighbor_table(csr)
    jmean = tmean = None
    if use_spmm:
        gcn = kw.get("gcn_aggregator", False)
        jmean = jsage.build_mean_adjacencies(csr, gcn=gcn, backend="segment")
        tmean = tsage.build_mean_adjacencies(csr, gcn=gcn, backend=backend)
    jten.adj = jsage.ELLGraph(table=jtab, valid=jval, nnz=csr.nnz,
                              mean_adj=jmean, mean_adj_gcn=jmean)
    tten.adj = tsage.ELLGraph(table=ttab, valid=tval, nnz=csr.nnz,
                              mean_adj=tmean, mean_adj_gcn=tmean)
    jten.adj_hops = tten.adj_hops = []
    nl = jds.num_labels
    jmodel = jsage.GraphSAGENetwork(nl, hid_units=32, num_samples=(0, 0), **kw)
    tmodel = tsage.GraphSAGENetwork(nl, hid_units=32, num_samples=(0, 0), **kw)
    jparams = jmodel.init(jax.random.PRNGKey(5), jds.feature_dim)
    tmodel.init(tds.feature_dim, 1, torch.Generator().manual_seed(0))
    tsage.load_jax_graphsage_params(
        tmodel, {k: np.asarray(v) for k, v in jparams.items()})
    return jten, tten, jmodel, jparams, tmodel


@pytest.mark.parametrize("case", sorted(SAGE_CASES))
def test_graphsage_full_neighbor_forward_matches_jax(data_dir, case):
    _check_forward(_sage_pair(data_dir, case))


@pytest.mark.parametrize("backend", ["gscatter", "bsr", "cootile"])
def test_graphsage_mean_adjacency_through_kernel_plain_versions(data_dir,
                                                                backend):
    """The non-symmetric D⁻¹A through each kernel's plain version: forward
    and the backward through its transpose payload, against the JAX
    package's gradient."""
    pair = _sage_pair(data_dir, "plain_spmm", backend)
    jten, tten, jmodel, jparams, tmodel = pair
    assert not tten.adj.mean_adj.symmetric
    _check_forward(pair)

    def jloss(p):
        logits = jmodel.apply(p, jten.adj, jten.features, [])
        return jmodel.loss(p, logits, jten.y_train, jten.train_mask)

    jgrads = jax.grad(jloss)(jparams)
    loss = tmodel.loss(tmodel(tten.adj, tten.features), tten.y_train,
                       tten.train_mask)
    loss.backward()
    for key in ("W1", "W2", "Wout"):
        np.testing.assert_allclose(_np(getattr(tmodel, key).grad),
                                   np.asarray(jgrads[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_graphsage_sampled_mean_draws_at_most_k_valid_neighbors():
    n = 50
    A = chip_smoke.build_graph(n=n, m_edges=200, seed=6)
    table, valid = tsage.build_neighbor_table(A)
    model = tsage.GraphSAGENetwork(3, num_samples=(2, 2))
    ell = tsage.ELLGraph(table=table, valid=valid, nnz=A.nnz)
    # x = one-hot node ids: the mean shows which neighbors were drawn
    x = torch.eye(n)
    mean = model._sampled_mean(ell, x, torch.Generator().manual_seed(1), 2)
    deg = np.diff(A.indptr)
    for i in range(n):
        drawn = np.flatnonzero(mean[i].numpy())
        assert len(drawn) == min(2, deg[i])
        assert set(drawn) <= set(A.indices[A.indptr[i]:A.indptr[i + 1]])
    # evaluation draws from a fixed seed
    model.init(n, 1, torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_array_equal(_np(model(ell, x)), _np(model(ell, x)))


# ------------------------------------------------------------ train steps
def _args(ds, tensors):
    return Namespace(
        objects={"dataset": ds, "tensors": vars(tensors),
                 "post_epoch_callbacks": deque(),
                 "post_train_callbacks": deque()},
        random_seed=123, grad_monitor=False, verbose=False, use_signac=False,
        deg_acc_monitor=[], best_val_criteria="val_acc", current_epoch=0)


def _run_steps(jargs, targs, n=10):
    j_losses, t_losses = [], []
    for epoch in range(1, n + 1):
        jargs.current_epoch = targs.current_epoch = epoch
        j_losses.append(float(jargs.objects["train_step"](
            **jargs.objects["tensors"])["train_loss"]))
        t_losses.append(float(targs.objects["train_step"](
            **targs.objects["tensors"])["train_loss"]))
    np.testing.assert_allclose(t_losses, j_losses, **STEPS)
    j_stats = jargs.objects["test_step"](**jargs.objects["tensors"])
    t_stats = targs.objects["test_step"](**targs.objects["tensors"])
    for key in ("val_loss", "test_loss", "val_acc"):
        np.testing.assert_allclose(float(t_stats[key]), float(j_stats[key]),
                                   **STEPS, err_msg=key)


@pytest.mark.parametrize("variant", ["gcn", "cheby", "bp"])
def test_gcn_train_steps_match_jax_runtime(data_dir, variant):
    jten, tten, jmodel, jparams, tmodel = _gcn_pair(data_dir, variant)
    jds, tds = _datasets(data_dir,
                         features="labels" if variant == "bp" else "row")
    jargs, targs = _args(jds, jten), _args(tds, tten)
    j_runtime.initialize_model(jargs, jmodel, "adam", 0.01, 0)
    t_runtime.initialize_model(targs, tmodel, "adam", 0.01, 0)
    if variant != "bp":
        load_jax_params(tmodel, [{k: np.asarray(v) for k, v in p.items()}
                                 for p in jargs.objects["state"]["params"]])
    _run_steps(jargs, targs)


def test_mixhop_train_steps_match_jax_runtime(data_dir):
    """Scheduled SGD: lr0 0.5 less 40% of it every 3 steps, floored at 0
    (steps 9 and 10 take a zero step)."""
    jten, tten, jmodel, jparams, tmodel = _mixhop_pair(data_dir, "published")
    jds, tds = _datasets(data_dir)
    lr0, ratio, every = 0.5, 0.4, 3
    dec = ratio * lr0
    tx = optax.sgd(lambda c: jnp.maximum(lr0 - dec * (c // every), 0.0))
    jargs, targs = _args(jds, jten), _args(tds, tten)
    j_runtime.initialize_model(jargs, jmodel, tx, lr0, JPatience(50),
                               es_metric="val_acc")
    schedule = tmix.linear_decrement(lr0, ratio, every)
    t_runtime.initialize_model(
        targs, tmodel, lambda p: t_runtime.ScheduledSGD(p, schedule), lr0,
        PatienceEarlyStopping(50), es_metric="val_acc")
    jp = jargs.objects["state"]["params"]
    tmix.load_jax_mixhop_params(tmodel, _mixhop_np(jp))
    _run_steps(jargs, targs)
    assert targs.objects["optimizer"].param_groups[0]["count"] == 10
    assert targs.objects["optimizer"].param_groups[0]["lr"] == 0.0


def test_graphsage_train_steps_match_jax_runtime(data_dir):
    jten, tten, jmodel, jparams, tmodel = _sage_pair(data_dir, "plain_spmm")
    jds, tds = _datasets(data_dir, features=None)
    jargs, targs = _args(jds, jten), _args(tds, tten)
    j_runtime.initialize_model(jargs, jmodel, "sgd", 0.7, 0)
    t_runtime.initialize_model(targs, tmodel, "sgd", 0.7, 0)
    tsage.load_jax_graphsage_params(
        tmodel, {k: np.asarray(v)
                 for k, v in jargs.objects["state"]["params"].items()})
    _run_steps(jargs, targs)


# -------------------------------------------------------------- optimizers
def _schedule_pair():
    lr0, ratio, every = 0.3, 0.25, 2
    return (lambda c: jnp.maximum(lr0 - ratio * lr0 * (c // every), 0.0),
            tmix.linear_decrement(lr0, ratio, every))


OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1),
            lambda p: torch.optim.SGD(p, lr=0.1)),
    "momentum_nesterov": (
        lambda: optax.sgd(0.1, momentum=0.7, nesterov=True),
        lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.7, nesterov=True)),
    "rmsprop": (lambda: j_runtime.get_optimizer("rmsprop", 0.01),
                lambda p: t_runtime.get_optimizer("rmsprop", p, 0.01)),
    "adagrad": (lambda: j_runtime.get_optimizer("adagrad", 0.05),
                lambda p: t_runtime.get_optimizer("adagrad", p, 0.05)),
    "adam": (lambda: j_runtime.get_optimizer("adam", 0.01),
             lambda p: t_runtime.get_optimizer("adam", p, 0.01)),
    "sgd_table": (lambda: j_runtime.get_optimizer("sgd", 0.2),
                  lambda p: t_runtime.get_optimizer("sgd", p, 0.2)),
    "scheduled_sgd": (lambda: optax.sgd(_schedule_pair()[0]),
                      lambda p: t_runtime.ScheduledSGD(p, _schedule_pair()[1])),
    "scheduled_momentum": (
        lambda: optax.sgd(_schedule_pair()[0], momentum=0.7, nesterov=True),
        lambda p: t_runtime.ScheduledSGD(p, _schedule_pair()[1],
                                         momentum=0.7, nesterov=True)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(11)
    shapes = {"a": (5, 4), "b": (7,), "empty": (3, 0)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              * (rng.random(s) > 0.2) for k, s in shapes.items()}
             for _ in range(10)]
    make_tx, make_opt = OPTIMIZERS[name]
    tx = make_tx()
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt = make_opt(list(tparams.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(_np(tparams[k]), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        t_runtime.get_optimizer("lamb", [torch.nn.Parameter(torch.ones(1))],
                                0.1)


def test_adjacency_powers_parser_matches_jax():
    for spec, layer_dims in (("0,1,2", (60,)), ("0:20:10,1:10:10", (60,)),
                             ("0:24:0,1:18:7,2:18:7", (60, 14))):
        ours = tmix.AdjacencyPowersParser(spec)
        ref = jmix.AdjacencyPowersParser(spec)
        assert ours.powers() == ref.powers()
        assert ours.output_capacity(7) == ref.output_capacity(7)
        for j in range(6):
            for d in layer_dims:
                assert ours.divide_capacity(j, d) == ref.divide_capacity(j, d)
    p = tmix.AdjacencyPowersParser("0:20:10,1:10:10")
    assert p.powers() == [0, 1]
    assert p.output_capacity(7) == 20
    assert p.divide_capacity(0, 60) == [40, 20]
    assert p.divide_capacity(5, 60) == [30, 30]
    assert tmix.AdjacencyPowersParser("0,1,2").output_capacity(7) == 21
    with pytest.raises(ValueError):
        tmix.AdjacencyPowersParser("0:5,1")


def test_mixhop_architecture_round_trip(tmp_path):
    _, model = _mixhop_models(MIXHOP_SPECS["published"], 7, l2reg=5e-3)
    path = tmix.save_architecture(model, tmp_path / "architecture.json")
    back = tmix.load_architecture(path)
    assert back.powers == model.powers
    assert back.layer_capacities == model.layer_capacities
    assert back.l2reg == 5e-3 and back.input_dropout == 0.0
    # the JAX package reads the same file
    ref = jmix.load_architecture(path)
    assert ref.layer_capacities == model.layer_capacities


# --------------------------------------------------------------------- CLI
CLI_RUNS = {
    "gcn": ["GCN", "--variant", "gcn"],
    "cheby": ["GCN", "--variant", "cheby", "--sparse_backend", "gscatter"],
    "cheby_arpack": ["GCN", "--variant", "cheby", "--cheby_eigenvalue", "-1"],
    "concat2": ["GCN", "--variant", "concat2", "--sparse_backend", "bsr"],
    "cheby_concat2": ["GCN", "--variant", "cheby_concat2"],
    "mlp": ["GCN", "--variant", "mlp"],
    "bp": ["GCN", "--variant", "bp", "--feature_configs", "labels",
           "--sparse_backend", "cootile"],
    "mixhop": ["MIXHOP", "--adj_pows", "0:24:0,1:18:7,2:18:7",
               "--hidden_dims_csv", "60", "--l2reg", "5e-3",
               "--val_size", "60"],
    "mixhop_momentum": ["MIXHOP", "--optimizer", "momentum",
                        "--partition", "planetoid", "--adj_pows", "0,1,2"],
    "sage_sampled": ["GRAPHSAGE", "--num_samples", "5", "5",
                     "--batch_size", "16"],
    "sage_full": ["GRAPHSAGE", "--num_samples", "0", "0", "--batch_size",
                  "16", "--model_class", "SupervisedGraphSageConcat"],
    "h2gcn_mlp": ["H2GCN", "--network_setup", "M64-R-D0.5-MO",
                  "--optimizer", "rmsprop"],
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_runs_each_baseline_on_the_cpu(data_dir, tmp_path, run):
    model, *flags = CLI_RUNS[run]
    ckpt = tmp_path / "ckpt"
    args = run_experiments.main(
        [model, "planetoid", "--dataset", f"ind.{NAME}", "--dataset_path",
         data_dir, "--device", "cpu", "--epochs", "3", "--timing",
         "--checkpoint_dir", str(ckpt)] + flags)
    assert args.current_epoch == 3
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        assert np.isfinite(float(stats[key])), key
    assert len(glob.glob(str(ckpt / "*" / "ckpt.pt"))) == 1
    assert len(args.objects["epoch_times"]) == 3
    if model == "MIXHOP":
        spec = json.loads((ckpt / "architecture.json").read_text())
        assert spec["powers"] == args.objects["model"].powers
    if run == "sage_sampled":
        # the pre-epoch re-mask: a batch of 16 train nodes on the run's
        # device
        mask = args.objects["tensors"]["train_mask"]
        assert mask.device.type == "cpu" and int(mask.sum()) == 16
    if run == "h2gcn_mlp":
        assert tuple(args.objects["tensors"]["adj_hops"].shape) == (
            240, 2, 240)

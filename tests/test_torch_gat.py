"""The PyTorch port's GAT against the JAX package's, on the CPU.

GATNetwork with the same carried weights (load_jax_gat_params) gives the
JAX GATNetwork.apply's logits at rtol 1e-5 / atol 1e-6 and the gradients
of its loss at rtol 1e-4 / atol 1e-5, through the segment path and the
fused path (the port's plain attention; JAX's Pallas kernels in interpret
mode), with the residual on and off. The helpers (segment_softmax, the
attention support, the payload routing, the patience controller) match
their JAX counterparts, and the CLI trains GAT through the fused path on
the CPU."""

import glob
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import h2gcn_tpu.models.GAT as jgat
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.models import GAT as tgat
from h2gcn_tpu_torch.nn import load_jax_gat_params
from h2gcn_tpu_torch.nn.metrics import masked_softmax_cross_entropy

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _graph(n, m, seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    a = sp.csr_matrix((np.ones(m, np.float32), (r, c)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.float32)
    a.setdiag(0)
    a.eliminate_zeros()
    return a.tocsr()


def _support(n=300, m=900, seed=0):
    return ((_graph(n, m, seed) + sp.eye(n)) > 0).astype(np.float32).tocsr()


def _pair(support, n_feat, n_classes, *, fused, residual, seed=0):
    """The JAX model and params, and the port model carrying them."""
    kw = dict(hid_units=[8], n_heads=[3, 1], residual=residual,
              fused_attention=fused)
    jm = jgat.GATNetwork(n_classes, **kw)
    params = jm.init(jax.random.PRNGKey(seed), n_feat, 1)
    tm = tgat.GATNetwork(n_classes, **kw)
    tm.init(n_feat, 1, torch.Generator().manual_seed(seed))
    load_jax_gat_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_network_and_loss_gradients_match_jax(fused, residual):
    n, d, c = 300, 24, 5
    support = _support(n)
    rng = np.random.default_rng(1)
    x = rng.random((n, d)).astype(np.float32)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    mask = (rng.random(n) < 0.3).astype(np.float32)
    jm, params, tm = _pair(support, d, c, fused=fused, residual=residual)
    jadj = jgat.build_gat_adjacency(support, fused)
    tadj = tgat.build_gat_adjacency(support, fused)
    assert (tadj.bsr is not None) == fused

    def jloss(p):
        logits = jm.apply(p, jadj, jnp.asarray(x), [], training=False)
        return jm.loss(p, logits, jnp.asarray(labels), jnp.asarray(mask)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tlogits = tm(tadj, torch.from_numpy(x), [], training=False)
    tl = tm.loss(tlogits, torch.from_numpy(labels), torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **FWD)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **FWD)
    for li, heads in enumerate(jgrads["layers"]):
        for hi, g in enumerate(heads):
            for key, value in g.items():
                np.testing.assert_allclose(
                    tm.layers[li][hi][key].grad.numpy().reshape(
                        np.shape(value)), np.asarray(value),
                    err_msg=f"layer {li} head {hi} {key}", **GRAD)


def test_fused_path_is_taken_only_without_per_edge_state(monkeypatch):
    n, d, c = 300, 12, 4
    support = _support(n)
    x = torch.rand(n, d, generator=torch.Generator().manual_seed(0))
    tm = tgat.GATNetwork(c, hid_units=[8], n_heads=[2, 1],
                         fused_attention=True, attn_drop=0.0)
    tm.init(d, 1, torch.Generator().manual_seed(0))
    adj = tgat.build_gat_adjacency(support, True)
    calls = []
    real = tgat.gat_attention
    monkeypatch.setattr(tgat, "gat_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gen = torch.Generator().manual_seed(1)
    tm(adj, x, [], training=True, generator=gen)
    assert len(calls) == 2                       # attn_drop 0: fused trains
    tm(adj, x, [], training=False, capture={})
    assert len(calls) == 2                       # capture: segment path
    assert len(tm.last_attn_coefs) == 2
    tm.attn_drop = 0.6
    tm(adj, x, [], training=True, generator=gen)
    assert len(calls) == 2                       # attention dropout: segment
    tm(adj, x, [], training=False)
    assert len(calls) == 4                       # eval: fused


def test_segment_softmax_matches_jax():
    rng = np.random.default_rng(2)
    n, e = 50, 400
    rows = np.sort(rng.integers(0, n - 5, e)).astype(np.int32)  # empty tail
    logits = rng.standard_normal(e).astype(np.float32) * 3
    valid = rng.random(e) < 0.8
    ref = jgat.segment_softmax(jnp.asarray(logits), jnp.asarray(rows), n,
                               jnp.asarray(valid))
    got = tgat.segment_softmax(torch.from_numpy(logits),
                               torch.from_numpy(rows).long(), n,
                               torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("nhood", [1, 2])
def test_attention_support_matches_jax(nhood):
    ds = types.SimpleNamespace(sparse_adj=_graph(200, 500, 3),
                               num_samples=200)
    ref = jgat.build_attention_support(ds, nhood)
    got = tgat.build_attention_support(ds, nhood)
    assert abs(sp.csr_matrix(got) - sp.csr_matrix(ref)).max() == 0
    assert got.nnz == ref.nnz


def test_attention_support_inf():
    small = types.SimpleNamespace(sparse_adj=_graph(30, 40, 4),
                                  num_samples=30)
    got = tgat.build_attention_support(small, np.inf)
    ref = jgat.build_attention_support(small, np.inf)
    np.testing.assert_array_equal(got.toarray(), ref.toarray())
    big = types.SimpleNamespace(sparse_adj=None, num_samples=20_000)
    with pytest.raises(ValueError, match="finite --nhood"):
        tgat.build_attention_support(big, np.inf)


def test_gat_adjacency_routing(monkeypatch):
    support = _support(800, 4000, 5)
    small = tgat.build_gat_adjacency(support, fused_attention=True)
    jsmall = jgat.build_gat_adjacency(support, fused_attention=True)
    assert small.backend == jsmall.backend == "bsr"
    assert small.bsr.block_size == jsmall.bsr.block_size == 256
    assert small.bsr.blocks.dtype == torch.float32
    seg = tgat.build_gat_adjacency(support, fused_attention=False)
    jseg = jgat.build_gat_adjacency(support, fused_attention=False)
    assert seg.backend == jseg.backend == "segment" and seg.bsr is None
    assert seg.nnz == jseg.nnz == support.nnz
    # past the BSR budget both packages take the gather payload, and an
    # explicit payload overrides the budget
    monkeypatch.setattr(jgat, "_BSR_PAYLOAD_BUDGET_BYTES", 1)
    monkeypatch.setattr(tgat, "_BSR_PAYLOAD_BUDGET_BYTES", 1)
    for impl in ("auto", "coo", "gather"):
        j = jgat.build_gat_adjacency(support, True, attn_impl=impl)
        t = tgat.build_gat_adjacency(support, True, attn_impl=impl)
        assert t.backend == j.backend == "attn" and t.bsr is None
        assert type(t.attn).__name__ == type(j.attn).__name__
        assert t.nnz == j.nnz == support.nnz


def test_patience_controller_matches_jax():
    rng = np.random.default_rng(6)
    j, t = jgat.GATPatienceController(4), tgat.GATPatienceController(4)
    for _ in range(60):
        stats = {"val_acc": float(rng.choice([0.5, 0.6, 0.7])),
                 "val_loss": float(rng.random() + 1)}
        assert t(stats) == j(stats)
        assert (t.curr_step, t.vacc_mx, t.vlss_mn) == (
            j.curr_step, j.vacc_mx, j.vlss_mn)


def test_load_jax_gat_params_refuses_a_mismatch():
    support = _support(100, 200)
    jm, params, tm = _pair(support, 10, 3, fused=False, residual=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["layers"][0][0]["W"] = np.zeros((9, 8), np.float32)
    with pytest.raises(ValueError, match="layer 0 head 0 W"):
        load_jax_gat_params(tm, params)
    with pytest.raises(ValueError, match="2 heads"):
        load_jax_gat_params(tm, {"layers": [params["layers"][0][:2],
                                                 params["layers"][1]]})


@pytest.fixture(scope="module")
def planetoid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=600, m_edges=1800, seed=4)
    chip_smoke.write_planetoid(path, "syn", adj, seed=4, n_feat=200,
                               feats_per_row=5, n_test=150)
    return path


def test_cli_trains_gat_fused_on_cpu(planetoid, tmp_path, capsys):
    args = run_experiments.main([
        "GAT", "planetoid", "--dataset", "ind.syn", "--dataset_path",
        planetoid, "--device", "cpu", "--fused_attention", "--attn_drop",
        "0", "--epochs", "3", "--timing", "--checkpoint_dir",
        str(tmp_path / "ck")])
    assert args.current_epoch == 3
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        assert np.isfinite(float(stats[key]))
    adj = args.objects["tensors"]["adj"]
    assert adj.backend == "bsr" and adj.bsr.block_size == 256
    assert args.objects["tensors"]["adj_hops"] == []
    # --timing counts the attention support's edges when there are no hops
    assert stats["agg_edges_per_s"] == pytest.approx(
        3 * adj.nnz / stats["epoch_time_s"])
    assert glob.glob(str(tmp_path / "ck" / "*" / "ckpt.pt"))
    out = capsys.readouterr().out
    assert "Using model: h2gcn_tpu_torch.models.GAT" in out
    assert "Best performance:" in out

    # the trained model gives the same logits through both paths
    model, t = args.objects["model"], args.objects["tensors"]
    with torch.no_grad():
        fused = model(adj, t["features"], [], training=False)
        model.fused_attention = False
        seg = model(adj, t["features"], [], training=False)
    np.testing.assert_allclose(fused.numpy(), seg.numpy(), **FWD)
    loss = masked_softmax_cross_entropy(fused, t["y_val"], t["val_mask"])
    assert np.isfinite(float(loss))


def test_cli_refuses_an_unported_payload(planetoid, tmp_path):
    # every GAT and SpMM payload is ported (cootile, B3, last), and so are
    # the Chebyshev supports (they train), the row-sharded exact-hop split
    # and the mesh-sharded runtime (ROADMAP A9): --mesh_shards 2 spawns two
    # gloo ranks and trains, where it was refused before
    args = run_experiments.main([
        "H2GCN", "planetoid", "--dataset", "ind.syn", "--dataset_path",
        planetoid, "--device", "cpu", "--adj_norm_type", "CHEBY",
        "--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck")])
    assert np.isfinite(float(args.objects["epoch_stats"]["train_loss"]))
    args = run_experiments.main([
        "H2GCN", "planetoid", "--dataset", "ind.syn", "--dataset_path",
        planetoid, "--device", "cpu", "--mesh_shards", "2",
        "--epochs", "1", "--checkpoint_dir", str(tmp_path / "ck2")])
    best = args.objects["best_val_stats"]
    assert best["epoch"] == 1 and np.isfinite(best["train_loss"])

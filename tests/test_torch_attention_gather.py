"""The PyTorch port's gather-formulated attention against the JAX package's,
on the CPU.

The gather tables and edge <-> slot maps equal the JAX ones element for
element. The port's plain weighted combine (the kernel's CPU path) gives
JAX's _weighted_combine{,_aug} over the Pallas gscatter kernel in interpret
mode; the whole attention gives JAX's _make_attention (forward and three
gradients) with no mask, with one numpy-made dropout mask fed to both, on a
rectangular support and in "default" precision; the combine with explicit
coefficients and the coefficients themselves match too. Bounds: the JAX
tests', rtol 1e-4 / atol 1e-5 for values, rtol 1e-3 / atol 1e-5 for
gradients, 3e-2 for "default" (both round the gathered rows to bf16; JAX
also rounds the weighted product). The JAX side runs once per module under
jit. The payload routing of build_gat_adjacency, a two-layer GAT on the
gather and COO-chunk payloads against JAX's GATNetwork.apply, the fused
path's use of attention dropout and capture, and the CLI on the CPU are
held here as well."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import h2gcn_tpu.models.GAT as jgat
import h2gcn_tpu.sparse.pallas_attention_gather as pag
from h2gcn_tpu.sparse.pallas_gscatter import F_TILE
from h2gcn_tpu_torch import run_experiments, tracing
from h2gcn_tpu_torch.models import GAT as tgat
from h2gcn_tpu_torch.nn import load_jax_gat_params
from h2gcn_tpu_torch.sparse import attention_coo as tac
from h2gcn_tpu_torch.sparse import attention_gather as tag
from h2gcn_tpu_torch.sparse.gscatter import chunk_budget

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
GEO = dict(tile=64, e_b=32, kb=2)  # the JAX tests' small geometry


def _rand_support(n, m, deg, seed, loops=True):
    """``deg`` random sources a destination, plus self loops (square)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), deg)
    c = rng.integers(0, m, n * deg)
    a = sp.csr_matrix((np.ones(n * deg, np.float32), (r, c)), shape=(n, m))
    if loops:
        a = a + sp.eye(n, format="csr", dtype=np.float32)
    a.sum_duplicates()
    return a.tocsr()


# name -> (n, m, H, F, dropout mask, precision)
CASES = {"square": (300, 300, 4, 8, False, "highest"),
         "dropout": (300, 300, 4, 8, True, "highest"),
         "rectangular": (96, 288, 2, 8, False, "highest"),
         "wide": (200, 200, 4, 32, True, "highest"),
         "default": (300, 300, 4, 8, False, "default")}


def _case(name):
    n, m, H, F, drop, precision = CASES[name]
    a = _rand_support(n, m, 4, seed=1, loops=n == m)
    rng = np.random.default_rng(2)
    f1 = rng.standard_normal((n, H)).astype(np.float32)
    f2 = rng.standard_normal((m, H)).astype(np.float32)
    h = rng.standard_normal((m, H * F)).astype(np.float32)
    tgt = rng.standard_normal((n, H * F)).astype(np.float32)
    mask = None
    if drop:
        mask = np.where(rng.random((a.nnz, H)) < 0.4, 1 / 0.4,
                        0.0).astype(np.float32)
    return a, (f1, f2, h, tgt), mask, H, F, precision


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's whole attention (_make_attention: Pallas gscatter combines in
    interpret mode, under jit) per case: (out, (df1, df2, dh))."""
    res = {}
    for name in CASES:
        a, (f1, f2, h, tgt), mask, H, F, precision = _case(name)
        ga = pag.build_gatherattn(a, **GEO)
        attn = pag._make_attention(ga, H, F, 0.2, precision == "highest",
                                   True)
        m = jnp.ones((1, 1)) if mask is None else jnp.asarray(mask)

        def loss(f1, f2, h, attn=attn, m=m, tgt=tgt):
            out = attn(f1, f2, h, m)
            return jnp.sum(out * tgt), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, (0, 1, 2), has_aux=True))(*map(jnp.asarray, (f1, f2, h)))
        res[name] = (np.asarray(out), tuple(np.asarray(g) for g in grads))
    return res


@pytest.mark.parametrize("square", [True, False])
def test_gather_tables_match_jax(square):
    a = _rand_support(300, 300 if square else 700, 5, seed=3, loops=square)
    ref = pag.build_gatherattn(a, **GEO)
    got = tag.build_gatherattn(a, **GEO)
    for key in ("rows", "cols", "slot_fwd", "slot_bwd", "slot2edge_fwd",
                "slot2edge_bwd"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
    for key in ("n", "num_edges", "n_src", "num_src", "total_slots_fwd",
                "total_slots_bwd"):
        assert getattr(got, key) == getattr(ref, key), key
    for gs, jgs in ((got.fwd, ref.fwd), (got.bwd, ref.bwd)):
        assert len(gs.segments) == len(jgs.segments)
        for s, js in zip(gs.segments, jgs.segments):
            for key in ("ctr", "rows", "cols", "vals"):
                np.testing.assert_array_equal(getattr(s, key).numpy(),
                                              np.asarray(getattr(js, key)))
            assert (s.rb_lo, s.rb_hi, s.slot_lo, s.slot_hi) == (
                js.rb_lo, js.rb_hi, js.slot_lo, js.slot_hi)


@pytest.mark.parametrize("aug", [True, False])
def test_weighted_combine_matches_jax(aug):
    n, H, F = 300, 4, 8
    a = _rand_support(n, n, 4, seed=4)
    ga = pag.build_gatherattn(a, **GEO)
    tg = tag.build_gatherattn(a, **GEO)
    rng = np.random.default_rng(5)
    fw = F + 1 if aug else F
    wf = rng.random((a.nnz, H)).astype(np.float32)
    wf[rng.random((a.nnz, H)) < 0.3] = 0
    wl = rng.random((a.nnz, H)).astype(np.float32)
    x = rng.standard_normal((n, H * fw)).astype(np.float32)
    f_pad = -(-(H * fw) // F_TILE) * F_TILE
    xp = jnp.zeros((n, f_pad)).at[:, :H * fw].set(x)
    awf = pag._scatter_alpha(ga.slot2edge_fwd, jnp.asarray(wf))
    if aug:
        ref = pag._weighted_combine_aug(
            ga.fwd, awf, pag._scatter_alpha(ga.slot2edge_fwd, jnp.asarray(wl)),
            xp, H, F, True, True)
    else:
        ref = pag._weighted_combine(ga.fwd, awf, xp, H, F, True, True)
    got = tag.gscatter_weighted(tg.fwd, tg.slot2edge_fwd,
                                torch.from_numpy(wf), torch.from_numpy(x),
                                num_heads=H,
                                wl=torch.from_numpy(wl) if aug else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:n, :H * fw],
                               **FWD)
    # the CPU takes the plain one
    assert tracing.counter("launches.gscatter_weighted") == 0


@pytest.mark.parametrize("name", list(CASES))
def test_gather_attention_matches_jax(jax_ref, name):
    a, (f1, f2, h, tgt), mask, H, F, precision = _case(name)
    ga = tag.build_gatherattn(a, **GEO)
    xs = [torch.from_numpy(v).requires_grad_(True) for v in (f1, f2, h)]
    out = tag.gather_attention(
        ga, *xs, None if mask is None else torch.from_numpy(mask),
        num_heads=H, feat=F, precision=precision)
    (out * torch.from_numpy(tgt)).sum().backward()
    jout, jgrads = jax_ref[name]
    fwd, grad = (FWD, GRAD) if precision == "highest" else (BF16, BF16)
    np.testing.assert_allclose(out.detach().numpy(), jout, **fwd)
    for x, want, key in zip(xs, jgrads, ("df1", "df2", "dh")):
        np.testing.assert_allclose(x.grad.numpy(), want, err_msg=key, **grad)


def test_gather_dropout_mask_comes_from_the_generator():
    a, (f1, f2, h, _), _, H, F, _ = _case("square")
    ga = tag.build_gatherattn(a)
    xs = [torch.from_numpy(v) for v in (f1, f2, h)]
    kw = dict(num_heads=H, feat=F)
    out = tag.gat_attention_gather(ga, *xs, n_out=300, attn_drop=0.6,
                                   generator=torch.Generator().manual_seed(7),
                                   **kw)
    keep = torch.rand((a.nnz, H), generator=torch.Generator().manual_seed(7))
    m = torch.where(keep < 0.4, 1 / 0.4, 0.0)
    torch.testing.assert_close(out, tag.gather_attention(ga, *xs, m, **kw),
                               rtol=0, atol=0)
    plain = tag.gat_attention_gather(ga, *xs, n_out=300, **kw)
    assert not torch.allclose(out, plain)
    # no generator (evaluation): no dropout
    torch.testing.assert_close(
        tag.gat_attention_gather(ga, *xs, n_out=300, attn_drop=0.6, **kw),
        plain, rtol=0, atol=0)


def test_gather_coefficients_and_combine_match_jax():
    a, (f1, f2, h, tgt), _, H, F, _ = _case("square")
    ga = pag.build_gatherattn(a, **GEO)
    tg = tag.build_gatherattn(a, **GEO)
    ref = pag.gather_attention_coefficients(ga, jnp.asarray(f1),
                                            jnp.asarray(f2))
    alpha = tag.gather_attention_coefficients(tg, torch.from_numpy(f1),
                                              torch.from_numpy(f2))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(
        np.bincount(a.tocoo().row, alpha[:, 0].numpy()), 1.0, rtol=1e-5)

    combine = pag._make_combine(ga, H, F, True, True)

    def jloss(alpha, h):
        out = combine(alpha, h)
        return jnp.sum(out * tgt), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, (0, 1),
                                                   has_aux=True))(
        ref, jnp.asarray(h))
    xs = [alpha.clone().requires_grad_(True),
          torch.from_numpy(h).requires_grad_(True)]
    out = tag.gather_combine(tg, *xs, num_heads=H, feat=F)
    (out * torch.from_numpy(tgt)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    for x, want in zip(xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **GRAD)


def test_gat_adjacency_routes_past_the_budgets(monkeypatch):
    support = chip_smoke.self_looped(chip_smoke.build_graph(800, 4000, 5))
    routes = {}
    for impl in ("auto", "gather", "coo"):
        t = tgat.build_gat_adjacency(support, True, attn_impl=impl)
        j = jgat.build_gat_adjacency(support, True, attn_impl=impl)
        assert t.backend == j.backend
        routes[impl] = type(t.attn)
        assert type(t.attn).__name__ == type(getattr(j, "attn", None)).__name__
    # under the budget auto keeps the BSR mask; an explicit payload
    # overrides the budget
    assert routes == {"auto": type(None), "gather": tag.GatherAttn,
                      "coo": tac.AttnCoo}
    monkeypatch.setattr(tgat, "_BSR_PAYLOAD_BUDGET_BYTES", 1)
    past = tgat.build_gat_adjacency(support, True)
    assert past.backend == "attn" and isinstance(past.attn, tag.GatherAttn)
    assert past.bsr is None and past.nnz == support.nnz
    stream = tgat._gather_stream_bytes(support.shape[0], support.nnz)
    assert 0 < stream < tgat._GATHER_STREAM_BUDGET_BYTES
    monkeypatch.setattr(tgat, "_GATHER_STREAM_BUDGET_BYTES", stream - 1)
    coo = tgat.build_gat_adjacency(support, True)
    assert coo.backend == "attn" and isinstance(coo.attn, tac.AttnCoo)
    assert isinstance(tgat.build_gat_adjacency(
        support, True, attn_impl="gather").attn, tag.GatherAttn)
    # the transposed view of an asymmetric support carries no payload and
    # reports "segment"
    asym = _rand_support(300, 300, 4, seed=8)
    view = tgat.build_gat_adjacency(asym, True,
                                    attn_impl="coo").transpose_view()
    assert view.backend == "segment" and view.attn is None


def _gat_pair(n_feat, n_classes, seed=0, **kw):
    kw = dict(hid_units=[8], n_heads=[3, 1], fused_attention=True,
              attn_drop=0.0, in_drop=0.0, **kw)
    jm = jgat.GATNetwork(n_classes, **kw)
    params = jm.init(jax.random.PRNGKey(seed), n_feat, 1)
    tm = tgat.GATNetwork(n_classes, **kw)
    tm.init(n_feat, 1, torch.Generator().manual_seed(seed))
    load_jax_gat_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("impl", ["gather", "coo"])
def test_gat_on_the_at_scale_payloads_matches_jax(impl):
    """A two-layer GAT (3 heads of 8, then 1 of 5) on the ``impl`` payload:
    logits, loss and every parameter's gradient against JAX's
    GATNetwork.apply on the same payload (its kernels in interpret mode),
    dropout off."""
    n, d, c = 300, 24, 5
    support = chip_smoke.self_looped(chip_smoke.build_graph(n, 900, seed=3))
    rng = np.random.default_rng(1)
    x = rng.random((n, d)).astype(np.float32)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    mask = (rng.random(n) < 0.3).astype(np.float32)
    jm, params, tm = _gat_pair(d, c)
    jadj = jgat.build_gat_adjacency(support, True, attn_impl=impl)
    tadj = tgat.build_gat_adjacency(support, True, attn_impl=impl)
    assert jadj.backend == tadj.backend == "attn"
    assert isinstance(tadj.attn, tag.GatherAttn if impl == "gather"
                      else tac.AttnCoo)

    @jax.jit
    def jloss(p):
        logits = jm.apply(p, jadj, jnp.asarray(x), [], training=False)
        return jm.loss(p, logits, jnp.asarray(labels),
                       jnp.asarray(mask)), logits

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


def test_gather_payload_runs_dropout_and_capture_fused(monkeypatch):
    n, d, c = 300, 12, 4
    support = chip_smoke.self_looped(chip_smoke.build_graph(n, 900, seed=6))
    x = torch.rand(n, d, generator=torch.Generator().manual_seed(0))
    tm = tgat.GATNetwork(c, hid_units=[8], n_heads=[2, 1],
                         fused_attention=True, attn_drop=0.6)
    tm.init(d, 1, torch.Generator().manual_seed(0))
    adj = tgat.build_gat_adjacency(support, True, attn_impl="gather")
    calls = []
    real = tgat.gat_attention_gather
    monkeypatch.setattr(tgat, "gat_attention_gather",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    gen = torch.Generator().manual_seed(1)
    tm(adj, x, [], training=True, generator=gen)
    assert len(calls) == 2 and calls[0]["attn_drop"] == 0.6
    capture = {}
    fused = tm(adj, x, [], training=False, capture=capture)
    assert len(calls) == 4 and calls[-1]["attn_drop"] == 0.0
    coefs = tm.last_attn_coefs
    assert [tuple(a.shape) for a in coefs] == [(2, support.nnz),
                                               (1, support.nnz)]
    assert set(capture) == {"activations/0-gat", "activations/1-gat"}
    # the same coefficients and logits as the segment path's
    tm.fused_attention = False
    seg = tm(adj, x, [], training=False, capture={})
    np.testing.assert_allclose(fused.detach().numpy(), seg.detach().numpy(),
                               **FWD)
    for got, want in zip(coefs, tm.last_attn_coefs):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[:, :support.nnz].detach().numpy(),
                                   **FWD)


@pytest.fixture(scope="module")
def planetoid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=600, m_edges=1800, seed=4)
    chip_smoke.write_planetoid(path, "syn", adj, seed=4, n_feat=200,
                               feats_per_row=5, n_test=150)
    return path


@pytest.mark.parametrize("impl,precision", [("gather", "highest"),
                                            ("coo", "highest"),
                                            ("coo", "default")])
def test_cli_trains_gat_on_the_at_scale_payloads_on_cpu(planetoid, tmp_path,
                                                         impl, precision):
    """``--fused_attention --attn_impl {gather,coo}`` train on the CPU
    through the plain versions; gather with the published --attn_drop."""
    drop = "0.6" if impl == "gather" else "0"
    args = run_experiments.main([
        "GAT", "planetoid", "--dataset", "ind.syn", "--dataset_path",
        planetoid, "--device", "cpu", "--fused_attention", "--attn_impl",
        impl, "--attn_drop", drop, "--fused_precision", precision,
        "--epochs", "2", "--checkpoint_dir", str(tmp_path / "ck")])
    assert args.current_epoch == 2
    stats = args.objects["epoch_stats"]
    for key in ("train_loss", "val_loss", "test_loss"):
        assert np.isfinite(float(stats[key]))
    adj = args.objects["tensors"]["adj"]
    assert adj.backend == "attn"
    assert isinstance(adj.attn, tag.GatherAttn if impl == "gather"
                      else tac.AttnCoo)
    assert glob.glob(str(tmp_path / "ck" / "*" / "ckpt.pt"))
    model, t = args.objects["model"], args.objects["tensors"]
    assert model.fused_precision == precision
    with torch.no_grad():
        fused = model(adj, t["features"], [], training=False)
        model.fused_attention = False
        seg = model(adj, t["features"], [], training=False)
    tol = FWD if precision == "highest" else BF16
    np.testing.assert_allclose(fused.numpy(), seg.numpy(), **tol)


@pytest.mark.parametrize("sms", [4, 132])
@pytest.mark.parametrize("orient", ["fwd", "bwd"])
def test_combine_items_cover_every_chunk_once(orient, sms):
    """The combine kernel's work items over a hub-skewed self-looped
    support: every chunk of every segment once, in order, no item past the
    budget, and the heaviest stripe cut into more than one item."""
    support = chip_smoke.self_looped(chip_smoke.build_graph(3000, 20000,
                                                            seed=7))
    ga = tag.build_gatherattn(support)
    gs = ga.fwd if orient == "fwd" else ga.bwd
    items = tag.combine_items(gs, sms)
    # the payload's own items are cut for the H100 off the card
    assert [[t.tolist() for t in it] for it in tag.combine_items(gs)] == [
        [t.tolist() for t in it]
        for it in (ga.items_fwd if orient == "fwd" else ga.items_bwd)]
    assert len(items) == len(gs.segments)
    for seg, (item_ptr, item_stripe) in zip(gs.segments, items):
        ptr = seg.chunk_ptr.numpy()
        item_ptr, item_stripe = item_ptr.numpy(), item_stripe.numpy()
        assert item_ptr.dtype == item_stripe.dtype == np.int32
        assert item_ptr[0] == 0 and item_ptr[-1] == ptr[-1]
        sizes = np.diff(item_ptr)
        assert (sizes > 0).all()
        budget = chunk_budget(int(ptr[-1]), gs.e_b, sms)
        assert sizes.max() <= budget
        # each item starts in the stripe it names
        np.testing.assert_array_equal(
            item_stripe, np.searchsorted(ptr, item_ptr[:-1], side="right") - 1)
        # the hub stripe, past the budget, is cut into near-equal items
        heavy = int(np.argmax(np.diff(ptr)))
        assert np.diff(ptr)[heavy] > max(budget, 2 * np.median(np.diff(ptr)))
        hub = sizes[item_stripe == heavy]
        assert len(hub) == -(-np.diff(ptr)[heavy] // budget) > 1
        assert hub.max() - hub.min() <= 1


def test_combine_width_fits_shared_memory():
    from h2gcn_tpu_torch.sparse.gscatter import _MAX_SHARED

    # layer 1's augmented width, 8 heads of 8 + 1: three 32-column lanes
    assert tag.combine_width(tag.GATHER_TILE, 72) == 96
    assert tag.combine_width(128, 128) == 128
    # 512 x 128 f32 is past the 227 KB a block can have
    assert tag.combine_width(512, 128) == 96
    assert tag.combine_width(512, 8) == 32 and tag.combine_width(512, 64) == 64
    for f in (7, 8, 64, 72, 520):
        w = tag.combine_width(tag.GATHER_TILE, f)
        assert tag.GATHER_TILE * w * 4 <= _MAX_SHARED
        assert w >= min(f, 96)

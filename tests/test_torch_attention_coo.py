"""The PyTorch port's COO-chunk attention against the JAX package's, on the
CPU.

The chunk tables (build_chunk_tables, build_attn_coo in both visit orders,
also cut into many segments) equal the JAX tables element for element. The
port's plain versions (the kernels' CPU path) give the JAX Pallas kernels'
forward, row statistics and three gradients, run in interpret mode once
per module under jit, at the JAX tests' bounds: rtol 1e-4 / atol 1e-5 for
values, rtol 1e-3 / atol 1e-5 for gradients, and 3e-2 for "default"
precision (the port rounds the contractions' operands to bf16; the JAX
kernels on the CPU contract in f32). The GAT model and CLI on this payload
are held in test_torch_attention_gather.py, beside the gather payload."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import h2gcn_tpu.sparse.pallas_attention_coo as pac
import h2gcn_tpu.sparse.pallas_cootile as pct
from h2gcn_tpu.sparse import transforms
from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.sparse import attention_coo as tac
from h2gcn_tpu_torch.sparse import cootile as tct

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
N, H, F, TILE, E_B = 520, 2, 8, 128, 32


def _support():
    """The JAX multi-segment test's asymmetric support (n = 520, density
    0.02, self loops), with rows 140-199 and columns 300-339 emptied: rows
    without an edge keep the sentinel, sources without one get zero
    gradients."""
    a = sp.random(N, N, density=0.02, random_state=1, format="csr")
    a = transforms.add_eye((a > 0).astype(np.float32)).tolil()
    a[140:200, :] = 0
    a[:, 300:340] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _tables_equal(jsegs, tsegs):
    assert len(jsegs) == len(tsegs)
    for js, ts in zip(jsegs, tsegs):
        for key in ("grp", "oth", "rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(ts, key).numpy(),
                                          np.asarray(getattr(js, key)),
                                          err_msg=key)
        assert (ts.lo, ts.hi) == (js.lo, js.hi)
        grp = ts.grp.numpy()
        np.testing.assert_array_equal(
            ts.tile_ptr.numpy(),
            np.searchsorted(grp, np.arange(ts.lo, ts.hi + 1)))


@pytest.mark.parametrize("tile,e_b", [(128, 32), (256, 128), (64, None)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_chunk_tables_match_jax(tile, e_b, symmetric):
    a = _support()
    if symmetric:
        a = ((a + a.T) > 0).astype(np.float32).tocsr()
    ref = pct.build_chunk_tables(a, tile, e_b)
    got = tct.build_chunk_tables(a, tile, e_b)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("max_chunks", [None, 16])
def test_attn_coo_tables_match_jax(monkeypatch, max_chunks):
    a = _support()
    if max_chunks:
        monkeypatch.setattr(pac, "_MAX_CHUNKS", max_chunks)
    ref = pac.build_attn_coo(a, tile=TILE, e_b=E_B)
    got = tac.build_attn_coo(a, tile=TILE, e_b=E_B, max_chunks=max_chunks)
    if max_chunks:
        assert len(got.fwd) > 1 and len(got.bwd) > 1
    _tables_equal(ref.fwd, got.fwd)
    _tables_equal(ref.bwd, got.bwd)
    assert (got.tile, got.e_b, got.n, got.n_tiles, got.num_chunks) == (
        ref.tile, ref.e_b, ref.n, ref.n_tiles, ref.num_chunks)


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((N, H), (N, H), (N, H * F), (N, H * F))]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX kernels (interpret mode, under jit) on the multi-segment
    tables: {precision: (out, m, l, (df1, df2, dh))}."""
    a = _support()
    old = pac._MAX_CHUNKS
    pac._MAX_CHUNKS = 16
    try:
        ac = pac.build_attn_coo(a, tile=TILE, e_b=E_B)
    finally:
        pac._MAX_CHUNKS = old
    f1, f2, h, gw = (jnp.asarray(v) for v in _inputs())
    n_pad, _, h_pad, f_lane = pac._dims(ac, H, F)
    res = {}
    for precision in ("highest", "default"):
        def stats(f1, f2, h, precision=precision):
            f1p, f2p, hp = pac._pad_inputs(ac, (f1, f2, h),
                                           (f_lane, f_lane, h_pad))
            out, m, l = pac._coo_fwd_stats(ac, f1p, f2p, hp, H, F, 0.2, True,
                                           precision)
            return out[:N, :H * F], m[:, :H], l[:, :H]

        def loss(f1, f2, h, precision=precision):
            return jnp.sum(pac.gat_attention_coo(
                ac, f1, f2, h, num_heads=H, feat=F, n_out=N, interpret=True,
                precision=precision) * gw)

        out, m, l = jax.jit(stats)(f1, f2, h)
        grads = jax.jit(jax.grad(loss, (0, 1, 2)))(f1, f2, h)
        res[precision] = tuple(np.asarray(v) for v in (out, m, l)) + (
            tuple(np.asarray(g) for g in grads),)
    return res


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_coo_forward_and_stats_match_jax(jax_ref, precision):
    ac = tac.build_attn_coo(_support(), tile=TILE, e_b=E_B, max_chunks=16)
    f1, f2, h, _ = (torch.from_numpy(v) for v in _inputs())
    n_pad = ac.n_tiles * TILE
    out, m, l = tac.coo_fwd_stats(ac, *(tac.pad_rows(t, n_pad)
                                        for t in (f1, f2, h)),
                                  num_heads=H, feat=F, precision=precision)
    jout, jm, jl, _ = jax_ref[precision]
    tol = FWD if precision == "highest" else BF16
    np.testing.assert_allclose(out[:N].numpy(), jout, **tol)
    # f32 statistics in both modes; rows without an edge keep the sentinel
    # and l = 0 exactly
    np.testing.assert_allclose(m.numpy(), jm, **FWD)
    np.testing.assert_allclose(l.numpy(), jl, **FWD)
    empty = np.asarray(_support().sum(axis=1)).ravel() == 0
    assert empty[140:200].all()
    assert (m[:N][torch.from_numpy(empty)] == tac.NEG_INF).all()
    assert (l[:N][torch.from_numpy(empty)] == 0).all()
    np.testing.assert_array_equal(m[N:].numpy(), jm[N:])


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_coo_gradients_match_jax(jax_ref, precision):
    ac = tac.build_attn_coo(_support(), tile=TILE, e_b=E_B, max_chunks=16)
    f1, f2, h, gw = (torch.from_numpy(v) for v in _inputs())
    xs = [t.clone().requires_grad_(True) for t in (f1, f2, h)]
    out = tac.gat_attention_coo(ac, *xs, num_heads=H, feat=F, n_out=N,
                                precision=precision)
    (out * gw).sum().backward()
    tol = GRAD if precision == "highest" else BF16
    for x, want, name in zip(xs, jax_ref[precision][3], ("df1", "df2", "dh")):
        np.testing.assert_allclose(x.grad.numpy(), want, err_msg=name, **tol)
    # sources without an edge get no gradient
    assert (xs[2].grad[300:340] == 0).all() and (xs[1].grad[300:340] == 0).all()


def test_coo_wrappers_take_the_plain_version_on_the_cpu():
    ac = tac.build_attn_coo(_support(), tile=TILE, e_b=E_B)
    n_pad = ac.n_tiles * TILE
    f1, f2, h, g = (tac.pad_rows(torch.from_numpy(v), n_pad)
                    for v in _inputs())
    kw = dict(num_heads=H, feat=F)
    names = ("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col")
    before = tuple(tracing.counter("launches." + k) for k in names)
    out, m, l = tac.coo_fwd_stats(ac, f1, f2, h, **kw)
    d = tac.head_dots(g, out, H, F)
    df1 = tac.coo_bwd_row(ac, f1, f2, h, g, m, l, d, **kw)
    dh, df2 = tac.coo_bwd_col(ac, f1, f2, h, g, m, l, d, **kw)
    for got, want in zip(
            (out, m, l, df1, dh, df2),
            tac.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
            + (tac.coo_bwd_row_plain(ac, f1, f2, h, g, m, l, d, **kw),)
            + tac.coo_bwd_col_plain(ac, f1, f2, h, g, m, l, d, **kw)):
        assert torch.equal(got, want)
    assert tuple(tracing.counter("launches." + k)
                 for k in names) == before  # no kernel ran
    # the forward-only entry on unpadded inputs
    assert torch.equal(tac.coo_gat_attention(
        ac, f1[:N], f2[:N], h[:N], n_out=N, **kw), out[:N])
    meta = h.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tac.coo_fwd_stats(ac, meta, meta, meta, **kw)
    with pytest.raises(ValueError, match="square"):
        tac.build_attn_coo(sp.random(30, 40, density=0.1, format="csr"))

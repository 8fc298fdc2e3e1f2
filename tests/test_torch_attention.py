"""Fused BSR graph attention of the PyTorch port against the JAX package.

The plain versions of the three kernels (forward with stats, row backward,
column backward) are held against the JAX Pallas kernels run in interpret
mode on the CPU: ``bsr_gat_attention``, ``_fwd_stats_call`` (out, m, l) and
``jax.grad`` of ``gat_attention``. Tolerances are those of the JAX
package's own tests (tests/test_extensions.py): forward rtol 1e-5 /
atol 1e-6, gradients rtol 1e-4 / atol 1e-5. Both sides sum in f32 in
another order. The BSR tables, colmajor_order included, must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu.sparse.matrix import _build_bsr as j_build_bsr
from h2gcn_tpu.sparse.pallas_attention import (_fwd_stats_call,
                                               _pad_attn_inputs,
                                               bsr_gat_attention,
                                               gat_attention)
from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.sparse import SparseMatrix
from h2gcn_tpu_torch.sparse import attention as tatt
from h2gcn_tpu_torch.sparse.matrix import _build_bsr as t_build_bsr

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)

# (B, n, H, F, self loops, an empty block row and column)
CASES = {
    "b128_h3_f8": (128, 150, 3, 8, True, False),
    "b128_h1_f7": (128, 400, 1, 7, True, False),
    "b256_h8_f8": (256, 300, 8, 8, True, False),
    "b256_h3_f7": (256, 600, 3, 7, True, False),
    "b128_fillers_no_loops": (128, 500, 3, 7, False, True),
}


def _mask(n, B, seed, self_loops=True, empty=False):
    a = sp.random(n, n, density=0.03, random_state=seed, format="csr")
    a = ((a + a.T) > 0).astype(np.float32)
    if self_loops:
        a = a + sp.eye(n, dtype=np.float32)
    a = (a > 0).astype(np.float32).tolil()
    if empty:  # block row and column 1 hold no entry: filler blocks
        a[B:2 * B, :] = 0
        a[:, B:2 * B] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _inputs(case, seed=0):
    B, n, H, F, loops, empty = CASES[case]
    rng = np.random.default_rng(seed)
    a = _mask(n, B, seed + 1, loops, empty)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((n, H), (n, H), (n, H * F), (n, H * F))]
    return a, B, n, H, F, arrs


@pytest.mark.parametrize("B", [128, 256])
@pytest.mark.parametrize("empty", [False, True])
def test_bsr_tables_and_colmajor_order_match_jax(B, empty):
    a = _mask(600, B, 3, self_loops=not empty, empty=empty)
    jb = j_build_bsr(a, B)
    tb = t_build_bsr(a, B)
    np.testing.assert_array_equal(tb.blocks.numpy(), np.asarray(jb.blocks))
    np.testing.assert_array_equal(tb.block_rows.numpy(),
                                  np.asarray(jb.block_rows))
    np.testing.assert_array_equal(tb.block_cols.numpy(),
                                  np.asarray(jb.block_cols))
    np.testing.assert_array_equal(tb.colmajor_order.numpy(),
                                  np.asarray(jb.colmajor_order))
    # col_ptr delimits each block column in the column-major order
    cols = tb.block_cols.numpy()[tb.colmajor_order.numpy()]
    ptr = tb.col_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == cols.size
    for c in range(tb.n_col_blocks):
        seg = cols[ptr[c]:ptr[c + 1]]
        assert seg.size >= 1 and (seg == c).all()


def test_from_scipy_builds_the_256_block_f32_mask():
    a = _mask(700, 256, 4)
    sm = SparseMatrix.from_scipy(a, backend="bsr", block_size=256)
    b = sm.bsr
    assert b.block_size == 256 and b.blocks.dtype == torch.float32
    assert b.blocks.shape[1:] == (256, 256)
    assert b.n_row_blocks == b.n_col_blocks == 3
    dense = np.zeros((3 * 256, 3 * 256), np.float32)
    for blk, r, c in zip(b.blocks.numpy(), b.block_rows.numpy(),
                         b.block_cols.numpy()):
        dense[r * 256:(r + 1) * 256, c * 256:(c + 1) * 256] += blk
    np.testing.assert_array_equal(dense[:700, :700], a.toarray())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_stats_match_jax_interpret(case):
    a, B, n, H, F, (f1, f2, h, _) = _inputs(case)
    jb = j_build_bsr(a, B)
    tb = t_build_bsr(a, B)
    ref = bsr_gat_attention(jb, jnp.asarray(f1), jnp.asarray(f2),
                            jnp.asarray(h), num_heads=H, feat=F, n_out=n,
                            interpret=True)
    got = tatt.bsr_gat_attention(tb, torch.from_numpy(f1),
                                 torch.from_numpy(f2), torch.from_numpy(h),
                                 num_heads=H, feat=F, n_out=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)

    # out, m, l of the stats kernel, on the padded rows too
    f1p, f2p, hp = _pad_attn_inputs(jb, jnp.asarray(f1), jnp.asarray(f2),
                                    jnp.asarray(h), H, F)
    j_out, j_m, j_l = _fwd_stats_call(jb, f1p, f2p, hp, H, F, 0.2, True)
    n_pad = tb.n_row_blocks * B
    t_out, t_m, t_l = tatt.gat_fwd_stats_plain(
        tb, *(tatt.pad_rows(torch.from_numpy(x), n_pad) for x in (f1, f2, h)),
        num_heads=H, feat=F)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out)[:, :H * F],
                               **FWD)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m)[:, :H], **FWD)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l)[:, :H], **FWD)
    if case == "b128_fillers_no_loops":
        # rows without an entry: m keeps the sentinel, l and out are 0
        lonely = np.asarray(a.sum(axis=1)).ravel() == 0
        assert lonely[B:2 * B].all() and lonely.sum() >= B
        assert (t_l.numpy()[:n][lonely] == 0).all()
        assert (t_out.numpy()[:n][lonely] == 0).all()
        assert (t_m.numpy()[:n][lonely] == tatt.NEG_INF).all()
        assert (t_out.numpy()[n:] == 0).all()
        for t in (t_out, t_m, t_l):
            assert torch.isfinite(t).all()


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad(case):
    a, B, n, H, F, (f1, f2, h, gw) = _inputs(case, seed=5)
    jb = j_build_bsr(a, B)
    tb = t_build_bsr(a, B)
    gwj = jnp.asarray(gw)
    ref = jax.grad(lambda *x: jnp.sum(gat_attention(
        jb, *x, num_heads=H, feat=F, n_out=n, interpret=True) * gwj),
        (0, 1, 2))(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(h))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (f1, f2, h)]
    out = tatt.gat_attention(tb, *xs, num_heads=H, feat=F, n_out=n)
    (out * torch.from_numpy(gw)).sum().backward()
    for name, t, r in zip(("df1", "df2", "dh"), xs, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   err_msg=name, **GRAD)
        assert torch.isfinite(t.grad).all()


def test_cpu_takes_the_plain_versions_and_other_devices_raise():
    a, B, n, H, F, (f1, f2, h, g) = _inputs("b128_h3_f8")
    tb = t_build_bsr(a, B)
    names = ("gat_fwd_stats", "gat_bwd_row", "gat_bwd_col")
    counts = tuple(tracing.counter("launches." + k) for k in names)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (f1, f2, h)]
    tatt.gat_attention(tb, *xs, num_heads=H, feat=F, n_out=n).sum().backward()
    assert counts == tuple(tracing.counter("launches." + k) for k in names)
    meta = torch.empty(tb.n_row_blocks * B, H * F, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.gat_fwd_stats(tb, meta, meta, meta, num_heads=H, feat=F)


@pytest.mark.parametrize("H,F", [(1, 513), (2, 300), (0, 8)])
def test_kernel_contract_refuses_unsupported_widths(H, F):
    a = _mask(200, 128, 7)
    tb = t_build_bsr(a, 128)
    with pytest.raises(ValueError, match="limit"):
        tatt._check("gat_fwd_stats", tb, H, F)


def test_kernel_contract_refuses_a_bf16_mask_and_bad_shapes():
    a = _mask(200, 128, 7)
    tb = t_build_bsr(a, 128, payload_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32 mask"):
        tatt._check("gat_fwd_stats", tb, 3, 8)
    tb = t_build_bsr(a, 128)
    with pytest.raises(ValueError, match="f1 must be float32"):
        tatt._check("gat_fwd_stats", tb, 3, 8, f1=torch.zeros(200, 3))


@pytest.mark.parametrize("case", ["b128_h3_f8", "b256_h8_f8"])
def test_plain_forward_is_deterministic_across_threads(case):
    """The plain forward sums in float64 and rounds once, so its result does
    not depend on how many CPU threads its einsum takes."""
    a, B, n, H, F, (f1, f2, h, _) = _inputs(case)
    tb = t_build_bsr(a, B)
    n_pad = tb.n_row_blocks * B
    xs = [tatt.pad_rows(torch.from_numpy(x), n_pad) for x in (f1, f2, h)]
    threads = torch.get_num_threads()
    outs = []
    try:
        for k in (1, 4):
            torch.set_num_threads(k)
            outs.append(tatt.gat_fwd_stats_plain(tb, *xs, num_heads=H,
                                                 feat=F))
    finally:
        torch.set_num_threads(threads)
    for one, four in zip(*outs):
        live = one > tatt.NEG_INF / 2
        scale = float(one[live].abs().max())
        assert float((one - four).abs().max()) <= 1e-7 * scale

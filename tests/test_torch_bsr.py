"""BSR tables and SpMM of the PyTorch port against the JAX package.

_build_bsr must give the JAX package's blocks, block coordinates (filler
blocks included) and column-major order. bsr_spmm_plain is held against
JAX spmm with backend="bsr" on the CPU (which reduces through the segment
path) and a dense oracle: at 1e-5 in "highest"; in "default" both operands
are rounded to bf16, so the error is held at 1e-2 of the output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu.sparse import SparseMatrix as JSparseMatrix
from h2gcn_tpu.sparse import spmm as jspmm
from h2gcn_tpu.sparse.matrix import _build_bsr as j_build_bsr
from h2gcn_tpu_torch.sparse import bsr_spmm as tbsr
from h2gcn_tpu_torch.sparse.matrix import _build_bsr as t_build_bsr


def _rand(n, m, density, seed):
    return sp.random(n, m, density=density, random_state=seed, format="csr",
                     dtype=np.float32)


def _cases():
    a = _rand(300, 300, 0.02, 1)
    b = _rand(200, 260, 0.03, 2).tolil()
    b[40:120, :] = 0      # empty block rows -> row fillers
    b[:, 100:200] = 0     # empty block columns -> column fillers
    return {"square": a, "rect_with_fillers": b.tocsr()}


@pytest.mark.parametrize("name", ["square", "rect_with_fillers"])
@pytest.mark.parametrize("block", [16, 32])
def test_build_bsr_identical(name, block):
    a = _cases()[name]
    a.eliminate_zeros()
    ours = t_build_bsr(a, block)
    ref = j_build_bsr(a, block)
    assert (ours.block_size, ours.n_row_blocks, ours.n_col_blocks) == (
        ref.block_size, ref.n_row_blocks, ref.n_col_blocks)
    for field in ("blocks", "block_rows", "block_cols"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    rp = ours.row_ptr.numpy()
    rows = ours.block_rows.numpy()
    for br in range(ours.n_row_blocks):
        assert rp[br + 1] > rp[br]  # every block row holds a block
        assert (rows[rp[br]:rp[br + 1]] == br).all()


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("name", ["square", "rect_with_fillers"])
def test_plain_matches_jax_and_dense(precision, name):
    a = _cases()[name]
    x = np.random.default_rng(0).standard_normal(
        (a.shape[1], 40)).astype(np.float32)
    bsr = t_build_bsr(a, 32)
    got = tbsr.bsr_spmm_plain(bsr, torch.from_numpy(x), n_out=a.shape[0],
                              precision=precision).numpy()
    jm = JSparseMatrix.from_scipy(a, backend="bsr", block_size=32,
                                  precision=precision)
    want = np.asarray(jspmm(jm, jnp.asarray(x)))
    for ref in (want, a.toarray() @ x):
        if precision == "highest":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err < 1e-2, err
    if precision == "default":
        # exactly the product of the bf16-rounded operands
        ab = torch.from_numpy(a.toarray()).to(torch.bfloat16).float()
        xb = torch.from_numpy(x).to(torch.bfloat16).float()
        np.testing.assert_allclose(got, (ab @ xb).numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_wrapper_checks_and_cpu_dispatch():
    a = _cases()["square"]
    bsr = t_build_bsr(a, 32)
    x = torch.randn(300, 8)
    before = tbsr.bsr_spmm.launches
    torch.testing.assert_close(
        tbsr.bsr_spmm(bsr, x, n_out=300),
        tbsr.bsr_spmm_plain(bsr, x, n_out=300))
    assert tbsr.bsr_spmm.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tbsr.bsr_spmm(bsr, x.to("meta"), n_out=300)
    with pytest.raises(ValueError, match="unknown precision"):
        tbsr.bsr_spmm(bsr, x, n_out=300, precision="fast")


@pytest.mark.parametrize("budget", [1, 3, 8, 40])
def test_items_cover_every_block_once(budget):
    # a block row of 45 blocks beside rows that hold only their filler
    a = sp.random(600, 5800, density=0.002, random_state=3, format="lil",
                  dtype=np.float32)
    a[:32, :] = sp.random(32, 5800, density=0.3, random_state=4)
    a[256:512, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    bsr = t_build_bsr(a, 128)
    rp = bsr.row_ptr.numpy()
    assert np.diff(rp).max() >= 40
    items = tbsr.build_items(rp, budget)
    br, lo, hi = items.T
    # in order, every block once, none over its budget, none out of its row
    assert lo[0] == 0 and hi[-1] == rp[-1]
    np.testing.assert_array_equal(lo[1:], hi[:-1])
    assert ((hi - lo) <= budget).all() and ((hi - lo) >= 1).all()
    assert (lo >= rp[br]).all() and (hi <= rp[br + 1]).all()
    # every block row, the filler-only ones included, gets an item
    np.testing.assert_array_equal(np.unique(br), np.arange(bsr.n_row_blocks))
    fill = np.flatnonzero(np.diff(rp) == 1)
    assert {2, 3} <= set(fill)
    # a row's items are near-equal runs
    for r in range(bsr.n_row_blocks):
        sizes = (hi - lo)[br == r]
        assert len(sizes) == -(-(rp[r + 1] - rp[r]) // budget)
        assert sizes.max() - sizes.min() <= 1

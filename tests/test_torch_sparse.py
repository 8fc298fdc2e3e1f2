"""spmm of the PyTorch port against the JAX package: forward and x.grad for
the dense, segment, gscatter and bsr backends on a symmetric and a
non-symmetric matrix (the backward then reads the transpose payload).
On the CPU gscatter and bsr run their plain versions; JAX reduces both
through its segment path. f32 in both, so 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu.sparse import SparseMatrix as JSM
from h2gcn_tpu.sparse import spmm as jspmm
from h2gcn_tpu_torch.sparse import SparseMatrix as TSM
from h2gcn_tpu_torch.sparse import spmm as tspmm


def _matrix(kind):
    a = sp.random(400, 400, density=0.02, random_state=3, format="csr",
                  dtype=np.float32)
    if kind == "symmetric":
        a = (a + a.T).tocsr()
    return a


@pytest.mark.parametrize("kind", ["symmetric", "nonsymmetric"])
@pytest.mark.parametrize("backend", ["dense", "segment", "gscatter", "bsr"])
def test_spmm_forward_and_grad_match_jax(backend, kind):
    a = _matrix(kind)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 24)).astype(np.float32)
    w = rng.standard_normal((400, 24)).astype(np.float32)

    jm = JSM.from_scipy(a, backend=backend)
    j_y = np.asarray(jspmm(jm, jnp.asarray(x)))
    j_g = np.asarray(jax.grad(
        lambda v: jnp.sum(jspmm(jm, v) * jnp.asarray(w)))(jnp.asarray(x)))

    tm = TSM.from_scipy(a, backend=backend)
    assert tm.symmetric == (kind == "symmetric")
    if kind == "nonsymmetric" and backend == "gscatter":
        # the backward's payload: a row-major copy of the transpose
        t = sp.csr_matrix(a.T)
        np.testing.assert_array_equal(tm.gsc_t.row_ptr.numpy(), t.indptr)
        np.testing.assert_array_equal(tm.gsc_t.cols.numpy(), t.indices)
        np.testing.assert_array_equal(tm.gsc_t.vals.numpy(), t.data)
    if kind == "nonsymmetric" and backend == "bsr":
        assert tm.bsr_t is not None
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tspmm(tm, xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), j_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), j_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), a @ x, rtol=1e-5,
                               atol=1e-5)


def test_coo_arrays_and_transpose_view_match_jax():
    a = _matrix("nonsymmetric")
    jm = JSM.from_scipy(a, backend="segment")
    tm = TSM.from_scipy(a, backend="segment")
    assert tm.nnz == jm.nnz and tm.shape == jm.shape
    for name in ("rows", "cols", "vals", "t_perm"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    jt, tt = jm.transpose_view(), tm.transpose_view()
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    assert (tm.to_scipy() != a).nnz == 0


def test_backend_rules():
    a = _matrix("symmetric")
    assert TSM.from_scipy(a).backend == "segment"  # auto on the CPU
    # cootile builds its tables on any device; on the CPU its SpMM is the
    # plain version over them
    tc = TSM.from_scipy(a, backend="cootile")
    assert tc.backend == "cootile" and tc.coot is not None
    x = np.random.default_rng(1).standard_normal(
        (a.shape[1], 4)).astype(np.float32)
    np.testing.assert_allclose(tspmm(tc, torch.from_numpy(x)).numpy(),
                               a @ x, rtol=1e-5, atol=1e-5)
    # "attn" keeps the COO arrays and an attention payload; its SpMM runs
    # on the COO arrays, as "segment"
    for impl, kind in (("coo", "AttnCoo"), ("gather", "GatherAttn")):
        tm = TSM.from_scipy(a, backend="attn", attn_impl=impl)
        assert tm.backend == "attn" and type(tm.attn).__name__ == kind
        x = np.random.default_rng(0).standard_normal(
            (a.shape[1], 4)).astype(np.float32)
        np.testing.assert_allclose(tspmm(tm, torch.from_numpy(x)).numpy(),
                                   a @ x, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        TSM.from_scipy(a, backend="attn", attn_impl="nope")
    with pytest.raises(ValueError):
        TSM.from_scipy(a, backend="nope")


@pytest.mark.parametrize("backend", ["gscatter", "bsr"])
def test_spmm_without_payload_segment_on_cpu_raises_elsewhere(backend):
    """A kernel backend whose payload was not built reduces through
    ``index_add_`` on the CPU, as the JAX package does, and raises on any
    other device (here ``meta``) instead of running plain code there."""
    a = _matrix("nonsymmetric")
    tm = TSM.from_scipy(a, backend=backend)
    bare = dataclasses.replace(tm, bsr=None, bsr_t=None, gsc=None,
                               gsc_t=None)
    x = np.random.default_rng(1).standard_normal((400, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tspmm(bare, xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), a @ x, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(),
                               a.T @ np.ones((400, 8), np.float32),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="no payload"):
        tspmm(bare, torch.empty(400, 8, device="meta"))

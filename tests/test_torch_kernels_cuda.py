"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs on a GPU machine without it:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``. Every
test here needs a CUDA GPU and nvcc and skips without them. Tolerance: the
kernels sum in another order than index_add_ / einsum (atomics, tiles), so
the error is held at 1e-5 of the output's scale; bf16 rounding is the same
on both sides."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
from h2gcn_tpu_torch.sparse import bsr_spmm as tbsr
from h2gcn_tpu_torch.sparse import gscatter as tgs

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= TOL * scale, (err, scale)


def _rand(n, m, nnz, seed, rows=None):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz) if rows is None else rng.integers(*rows, nnz)
    a = sp.csr_matrix((rng.random(nnz).astype(np.float32) + 0.5,
                       (r, rng.integers(0, m, nnz))), shape=(n, m))
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", ["plain", "segments", "megahub", "ragged"])
def test_gscatter_kernel_matches_plain(cuda, case, precision):
    kw = {}
    if case == "plain":
        a, f = _rand(3000, 3000, 40000, 0), 128
    elif case == "segments":
        a, f = _rand(5000, 4000, 60000, 1), 64
        kw = dict(max_steps=3)
    elif case == "megahub":
        a, f = _rand(2000, 2000, 20000, 2, rows=(1024, 1536)), 64
        kw = dict(max_steps=2)
    else:  # F not a multiple of 32, empty stripes, n not a multiple of 512
        a, f = _rand(1300, 900, 5000, 3, rows=(0, 400)), 45
    c = a.tocoo()
    gs = tgs.build_gscatter_coo(c.row, c.col, c.data, a.shape, device=cuda,
                                **kw)
    if case == "megahub":
        assert gs.overflow
    x = torch.randn(a.shape[1], f, device=cuda)
    before = tgs.gscatter_spmm.launches
    got = tgs.gscatter_spmm(gs, x, precision=precision)
    torch.cuda.synchronize()
    assert tgs.gscatter_spmm.launches > before
    _close(got, tgs.gscatter_spmm_plain(gs, x, precision=precision))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("shape,f", [((1000, 1000), 128), ((700, 1300), 45)])
def test_bsr_kernel_matches_plain(cuda, shape, f, precision):
    a = _rand(*shape, 30000, 4)
    sm = SparseMatrix.from_scipy(a, backend="bsr", precision=precision,
                                 device=cuda)
    x = torch.randn(shape[1], f, device=cuda)
    before = tbsr.bsr_spmm.launches
    got = tbsr.bsr_spmm(sm.bsr, x, n_out=shape[0], precision=precision)
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm.launches == before + 1
    _close(got, tbsr.bsr_spmm_plain(sm.bsr, x, n_out=shape[0],
                                    precision=precision))


@pytest.mark.parametrize("backend", ["gscatter", "bsr"])
def test_spmm_backward_reads_transpose_payload(cuda, backend):
    a = _rand(900, 900, 12000, 5)  # not symmetric
    sm = SparseMatrix.from_scipy(a, backend=backend, device=cuda)
    ref = SparseMatrix.from_scipy(a, backend="segment", device=cuda)
    x = torch.randn(900, 64, device=cuda, requires_grad=True)
    xr = x.detach().clone().requires_grad_(True)
    g = torch.randn(900, 64, device=cuda)
    counter = tgs.gscatter_spmm if backend == "gscatter" else tbsr.bsr_spmm
    y = spmm(sm, x)
    before = counter.launches
    y.backward(g)
    torch.cuda.synchronize()
    assert counter.launches > before  # the backward ran the kernel
    spmm(ref, xr).backward(g)
    _close(x.grad, xr.grad)


@pytest.mark.parametrize("backend", ["gscatter", "bsr"])
def test_spmm_without_payload_raises_on_the_card(cuda, backend):
    a = _rand(900, 900, 12000, 5)  # not symmetric
    sm = SparseMatrix.from_scipy(a, backend=backend, device=cuda)
    x = torch.randn(900, 64, device=cuda, requires_grad=True)
    no_t = dataclasses.replace(sm, bsr_t=None, gsc_t=None)
    y = spmm(no_t, x)
    with pytest.raises(RuntimeError, match="no payload"):
        y.backward(torch.randn(900, 64, device=cuda))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    a = _rand(500, 500, 3000, 6)
    gs = tgs.build_gscatter(a, tile=2048, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        tgs.gscatter_spmm(gs, torch.randn(500, 8, device=cuda))
    sm = SparseMatrix.from_scipy(a, backend="bsr", block_size=64, device=cuda)
    with pytest.raises(ValueError, match="128-blocks"):
        tbsr.bsr_spmm(sm.bsr, torch.randn(500, 8, device=cuda), n_out=500)

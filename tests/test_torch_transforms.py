"""Host graph transforms of the PyTorch port against the JAX package's
(scipy path, use_native=False): the results must be identical."""

import numpy as np
import pytest
import scipy.sparse as sp

from h2gcn_tpu.sparse import transforms as jt
from h2gcn_tpu_torch.sparse import transforms as tt


def _graph(n, density, seed, weighted=False):
    A = sp.random(n, n, density=density, random_state=seed, format="csr")
    if not weighted:
        A = ((A + A.T) > 0).astype(np.float32)
    A.setdiag(0)
    A.eliminate_zeros()
    return A.astype(np.float32)


def _same(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    assert a.dtype == b.dtype
    assert (a != b).nnz == 0


@pytest.mark.parametrize("n,density,seed,nhood", [
    (120, 0.03, 0, 2), (300, 0.01, 1, 3), (80, 0.2, 2, 4), (500, 0.004, 3, 2),
])
def test_nhood_split_identical(n, density, seed, nhood):
    A = _graph(n, density, seed)
    ours = tt.nhood_split(A, nhood, use_native=False)
    ref = jt.nhood_split(A, nhood, use_native=False)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _same(a, b)


def test_nhood_split_nan_is_all_ones():
    A = _graph(30, 0.1, 4)
    _same(tt.nhood_split(A, float("nan"), use_native=False)[0],
          jt.nhood_split(A, float("nan"), use_native=False)[0])


@pytest.mark.parametrize("ntype", ["ORDINARY", "SYM_NORMALIZED", "RW_NORMALIZED"])
@pytest.mark.parametrize("weighted", [False, True])
def test_normalize_identical(ntype, weighted):
    A = _graph(200, 0.03, 5, weighted=weighted).tolil()
    A[3, :] = 0  # a zero-degree row: the inf -> 0 guard
    A = A.tocsr()
    _same(tt.normalize(A, tt.NType[ntype]), jt.normalize(A, jt.NType[ntype]))


def test_row_normalize_and_eye_identical():
    F = sp.random(150, 40, density=0.1, random_state=6, format="csr",
                  dtype=np.float32).tolil()
    F[7, :] = 0
    F = F.tocsr()
    _same(tt.row_normalize(F), jt.row_normalize(F))
    A = _graph(90, 0.05, 7)
    _same(tt.add_eye(A), jt.add_eye(A))
    _same(tt.remove_eye(tt.add_eye(A)), jt.remove_eye(jt.add_eye(A)))

"""``backend='auto'``'s rule (``sparse/matrix.py``'s ``_auto_backend``),
called with device type ``"cuda"`` and no card: each case's matrix, the
route it gets, its block count against a brute-force count, and the
count's memory, linear in the entries whatever the block grid."""

import tracemalloc

import numpy as np
import pytest
import scipy.sparse as sp

from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.sparse import SparseMatrix
from h2gcn_tpu_torch.sparse import matrix as tmx

B = 128


def _blocks(n, per_block, seed, symmetric=True, m=None):
    """An ``n`` x ``m`` matrix with about ``per_block`` entries in every
    128-block (at most one entry per place)."""
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    a = sp.random(n, m, density=per_block / B ** 2, random_state=rng,
                  format="csr", dtype=np.float32)
    if symmetric:
        a = (a + a.T).tocsr()
    a.sum_duplicates()
    return a


def _large_sparse_grid():
    """2**22 nodes (a grid of 2**30 blocks, 8 GiB as one bincount), 4,000
    entries."""
    n = 1 << 22
    rng = np.random.default_rng(3)
    r, c = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    a = sp.csr_matrix((np.ones(4000, np.float32), (r, c)), shape=(n, n))
    a.sum_duplicates()
    return a


def _dense_payload_bytes(a):
    return tmx.block_occupancy(a)[0] * B * B * 4


# (matrix, precision, device type, symmetric, the cap's bytes as a function
# of the matrix or None for BSR_PAYLOAD_CAP, the route)
CASES = {
    # squirrel's Â₂: ~14,000 entries in every block
    "dense_blocks": (lambda: _blocks(600, 7000, 0), "highest", "cuda", True,
                     None, "bsr"),
    # squirrel's Â₁: ~260 entries a block
    "a1_like": (lambda: _blocks(600, 130, 1), "highest", "cuda", True, None,
                "gscatter"),
    "over_the_cap": (lambda: _blocks(600, 7000, 2), "highest", "cuda", True,
                     lambda a: _dense_payload_bytes(a) - 1, "gscatter"),
    # not symmetric: the transpose's payload counts too
    "transpose_over_the_cap": (
        lambda: _blocks(600, 14000, 3, symmetric=False, m=500), "highest",
        "cuda", False, lambda a: _dense_payload_bytes(a) + 1, "gscatter"),
    "transpose_under_the_cap": (
        lambda: _blocks(600, 14000, 3, symmetric=False, m=500), "highest",
        "cuda", False, lambda a: 2 * _dense_payload_bytes(a), "bsr"),
    # bf16 operands cross earlier: Â₁-like stays, ~1,000 a block goes
    "default_a1_like": (lambda: _blocks(600, 130, 4), "default", "cuda",
                        True, None, "gscatter"),
    "default_mid": (lambda: _blocks(600, 500, 4), "default", "cuda", True,
                    None, "bsr"),
    # between the two precisions' crossovers
    "highest_mid": (lambda: _blocks(600, 500, 4), "highest", "cuda", True,
                    None, "gscatter"),
    "cpu": (lambda: _blocks(600, 7000, 5), "highest", "cpu", True, None,
            "segment"),
    "large_sparse_grid": (_large_sparse_grid, "highest", "cuda", False,
                          None, "gscatter"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_auto_route(case, monkeypatch):
    build, precision, device_type, symmetric, cap, want = CASES[case]
    a = build()
    if cap is not None:
        monkeypatch.setattr(tmx, "BSR_PAYLOAD_CAP", cap(a))
    assert tmx._auto_backend(a, symmetric=symmetric, precision=precision,
                             device_type=device_type) == want

    coo = a.tocoo()
    keys = np.unique((coo.row // B).astype(np.int64) * (1 << 32)
                     + coo.col // B)
    n_rb, n_cb = -(-a.shape[0] // B), -(-a.shape[1] // B)
    empty = (n_rb - np.unique(coo.row // B).size
             + n_cb - np.unique(coo.col // B).size)
    tracemalloc.start()
    try:
        got = tmx.block_occupancy(a)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got == (keys.size, empty)
    # linear in the entries and the block rows and columns: no block grid
    assert peak <= 16 * (a.nnz + n_rb + n_cb) + (1 << 20), peak

    if device_type == "cpu":
        before = tracing.counter("route.segment")
        sm = SparseMatrix.from_scipy(a, backend="auto")
        assert sm.backend == "segment" and sm.gsc is None and sm.bsr is None
        assert tracing.counter("route.segment") == before + 1

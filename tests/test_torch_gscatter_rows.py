"""#1's row-major payload on the CPU: the work items of
``gscatter.row_schedule`` walked as ``csrc/gscatter.cu`` walks them (every
entry summed once, every row written once, each split row's pieces in
their own slots), and ``gscatter_rows_plain`` against ``a @ x``, also
through ``spmm``'s backward. No JAX here; f32, so 1e-5."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
from h2gcn_tpu_torch.sparse import gscatter as tgs


def _matrix(kind, seed=0):
    rng = np.random.default_rng(seed)
    n, m = 300, 250
    if kind == "hubs":
        # rows 0-2 hold most entries, the rest a sprinkle
        r = np.concatenate([rng.integers(0, 3, 600), rng.integers(0, n, 400)])
    elif kind == "empty_rows":
        # the first 20 rows, rows 100-179 and the last 60 hold nothing
        r = rng.integers(20, 240, 1500)
        r = r[(r < 100) | (r >= 180)]
    elif kind == "one_row":
        n, r = 1, np.zeros(200, np.int64)
    elif kind == "no_entries":
        r = np.zeros(0, np.int64)
    else:
        r = rng.integers(0, n, 2000)
    a = sp.csr_matrix((rng.random(r.size).astype(np.float32) + 0.5,
                       (r, rng.integers(0, m, r.size))), shape=(n, m))
    a.sum_duplicates()
    return a


def _payload(a, budget=None):
    return tgs.build_row_major(
        a.indptr, torch.from_numpy(a.indices.astype(np.int32)),
        torch.from_numpy(a.data), a.shape[1], budget=budget)


def _walk(rm):
    """The kernel's loop over every item, in order: how often each entry
    is summed and each row written, and each parked slot's row."""
    items = rm.items.numpy().astype(np.int64)
    splits = rm.splits.numpy().astype(np.int64)
    ptr = rm.row_ptr.numpy().astype(np.int64)
    n = len(ptr) - 1
    summed = np.zeros(rm.nnz, np.int64)
    written = np.zeros(n, np.int64)
    parked = {}
    arrived = np.zeros(rm.n_split, np.int64)
    for i in range(rm.n_items):
        e_lo, r_first, lo_split, hi_split = items[i]
        e_hi, r_next = items[i + 1, :2]
        for r in range(r_first, min(r_next, n - 1) + 1):
            start, end = ptr[r], ptr[r + 1]
            if r == r_next and start >= e_hi:
                break
            summed[max(start, e_lo):min(end, e_hi)] += 1
            began, goes_on = start < e_lo, end > e_hi
            if not (began or goes_on):
                written[r] += 1
                continue
            s = lo_split if began else hi_split
            assert s >= 0
            slot = splits[s, 0] + i - splits[s, 1]
            assert splits[s, 0] <= slot < splits[s + 1, 0]
            assert slot not in parked
            parked[slot] = r
            arrived[s] += 1
            if arrived[s] == splits[s + 1, 0] - splits[s, 0]:
                written[r] += 1
    return summed, written, parked


@pytest.mark.parametrize("budget", [1, 4, 17, 64, 100_000])
@pytest.mark.parametrize("kind", ["random", "hubs", "empty_rows", "one_row",
                                  "no_entries"])
def test_schedule_covers_every_entry_and_row_once(kind, budget):
    a = _matrix(kind)
    rm = _payload(a, budget)
    summed, written, parked = _walk(rm)
    assert (summed == 1).all()
    assert (written == 1).all()
    assert sorted(parked) == list(range(rm.n_slots))
    # the items tile the entries in order; none is longer than two budgets
    bounds = rm.items[:, 0].numpy()
    assert bounds[0] == 0 and bounds[-1] == a.nnz
    assert (np.diff(bounds) > 0).all() or a.nnz == 0
    assert (np.diff(bounds) <= 2 * budget).all()
    np.testing.assert_array_equal(rm.row_ptr.numpy(), a.indptr)


def test_a_row_longer_than_the_budget_is_split():
    a = _matrix("hubs")
    lengths = np.diff(a.indptr)
    budget = 64
    assert (lengths[:3] > 2 * budget).all() and (lengths[3:] <= budget).all()
    before = tracing.counter("gscatter.split_rows")
    rm = _payload(a, budget)
    # only the hub rows are split, each into an item's piece at a time
    assert rm.n_split == 3
    assert tracing.counter("gscatter.split_rows") - before == 3
    pieces = np.diff(rm.splits[:, 0].numpy())
    assert (pieces >= lengths[:3] // budget).all()
    _, _, parked = _walk(rm)
    assert sorted(set(parked.values())) == [0, 1, 2]
    # a short row stays whole even where a cut falls inside it
    whole = _payload(_matrix("random"), 64)
    assert whole.n_split == 0 and whole.n_items > 1


def test_empty_rows_are_written_as_zeros():
    a = _matrix("empty_rows")
    empty = np.flatnonzero(np.diff(a.indptr) == 0)
    assert empty[0] == 0 and empty[-1] == a.shape[0] - 1
    x = torch.randn(a.shape[1], 6)
    for budget in (4, 64):
        rm = _payload(a, budget)
        _, written, _ = _walk(rm)
        assert (written[empty] == 1).all()
        y = tgs.gscatter_rows_plain(rm, x)
        assert (y[empty] == 0).all()
        np.testing.assert_allclose(y.numpy(), a @ x.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("budget", [3, 64, None])
def test_plain_version_matches_a_x(budget, precision):
    a = _matrix("hubs", seed=1)
    rm = _payload(a, budget)
    x = torch.randn(a.shape[1], 45)
    y = tgs.gscatter_rows_plain(rm, x, precision=precision)
    xk = x.numpy()
    if precision == "default":
        xk = x.to(torch.bfloat16).float().numpy()
        # each product rounded to bf16: the error scales with the output
        err = np.abs(y.numpy() - a @ xk).max() / np.abs(a @ xk).max()
        assert err < 1e-2, err
    else:
        np.testing.assert_allclose(y.numpy(), a @ xk, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["symmetric", "nonsymmetric"])
def test_spmm_forward_and_backward_through_the_payload(kind):
    a = _matrix("hubs", seed=2)
    if kind == "symmetric":
        a = a[:a.shape[1]]
        a = (a + a.T).tocsr()
    sm = SparseMatrix.from_scipy(a, backend="gscatter")
    assert sm.symmetric == (kind == "symmetric")
    assert isinstance(sm.gsc, tgs.RowMajor)
    # the forward reads the matrix's own column and value arrays
    assert sm.gsc.cols is sm.cols and sm.gsc.vals is sm.vals
    if kind == "nonsymmetric":
        t = sp.csr_matrix(a.T)
        np.testing.assert_array_equal(sm.gsc_t.row_ptr.numpy(), t.indptr)
        np.testing.assert_array_equal(sm.gsc_t.cols.numpy(), t.indices)
        assert sm.transpose_view().gsc is sm.gsc_t
    else:
        assert sm.gsc_t is None
    rng = np.random.default_rng(3)
    x = rng.standard_normal((a.shape[1], 24)).astype(np.float32)
    g = rng.standard_normal((a.shape[0], 24)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = spmm(sm, xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), a @ x, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), a.T @ g, rtol=1e-5,
                               atol=1e-5)


def test_item_budget():
    assert tgs.item_budget(0, 10, 132) == tgs._MIN_ITEM_ENTRIES
    assert tgs.item_budget(10 ** 9, 10 ** 6, 132) == tgs.MAX_ITEM_ENTRIES
    # arXiv-year's Ã (2.5M entries, 15 a row): about 256 items an SM
    b = tgs.item_budget(2_501_829, 169_343, 132)
    assert b == -(-2_501_829 // (132 * tgs._ITEMS_PER_SM))
    # squirrel's Â₁ (434K entries, 83 a row): 1.5 mean rows
    assert tgs.item_budget(434_146, 5_201, 132) == 126


def test_payload_refuses_what_the_kernel_does_not_take():
    a = _matrix("random")
    with pytest.raises(ValueError, match="int32"):
        tgs.build_row_major(
            a.indptr, torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(a.data), a.shape[1])
    with pytest.raises(ValueError, match="one device"):
        tgs.build_row_major(
            a.indptr, torch.from_numpy(a.indices.astype(np.int32)),
            torch.from_numpy(a.data).to("meta"), a.shape[1])
    with pytest.raises(ValueError, match="fewer"):
        tgs.build_row_major(
            a.indptr, torch.from_numpy(a.indices[:10].astype(np.int32)),
            torch.from_numpy(a.data), a.shape[1])

"""gscatter tables and SpMM of the PyTorch port against the JAX package.

The port's build_gscatter_coo must produce the JAX package's tables value
for value (segments, overflow levels, slots). gscatter_spmm_plain is held
against the JAX Pallas kernel run in interpret mode: at 1e-5 in "highest"
(the two sum in a different order) and at 1e-4 of the output's scale in
"default", where both read x in bf16 and round the weighted product to bf16
before the f32 sum (pallas_gscatter.py:280); against the f32 dense product
"default" is held at 1e-2 of the scale (x in bf16). The kernel's work-item
schedule (build_schedule) is checked on its own.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import h2gcn_tpu.sparse.pallas_gscatter as jgs
import h2gcn_tpu_torch.sparse.gscatter as tgs
from h2gcn_tpu_torch import tracing


def _rand(n, nnz, seed=0):
    rng = np.random.default_rng(seed)
    a = sp.csr_matrix((rng.random(nnz).astype(np.float32) + 0.5,
                       (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
                      shape=(n, n))
    a.sum_duplicates()
    return a


def _assert_same_tables(ours, ref):
    assert (ours.tile, ours.e_b, ours.kb, ours.n_rows, ours.n_cols) == (
        ref.tile, ref.e_b, ref.kb, ref.n_rows, ref.n_cols)
    assert len(ours.segments) == len(ref.segments)
    for so, sr in zip(ours.segments, ref.segments):
        assert (so.rb_lo, so.rb_hi, so.slot_lo, so.slot_hi) == (
            sr.rb_lo, sr.rb_hi, sr.slot_lo, sr.slot_hi)
        for name in ("ctr", "rows", "cols", "vals"):
            np.testing.assert_array_equal(
                getattr(so, name).numpy(), np.asarray(getattr(sr, name)),
                err_msg=name)
        # the port's per-stripe chunk offsets cover every step in order
        ptr = so.chunk_ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == so.rows.shape[0]
        assert (np.diff(ptr) >= ours.kb).all()
    assert len(ours.overflow) == len(ref.overflow)
    for oo, orf in zip(ours.overflow, ref.overflow):
        _assert_same_tables(oo, orf)


def _coo(a):
    c = a.tocoo()
    return c.row, c.col, c.data


@pytest.mark.parametrize("case", ["plain", "segments_empty_rows", "megahub",
                                  "empty_stripe", "slots"])
def test_tables_identical(case):
    kw = dict(tile=64, e_b=32, kb=2)
    slots = False
    if case == "plain":
        a = _rand(700, 3000, seed=1)
        kw = dict(tile=128, e_b=32, kb=4)
    elif case == "segments_empty_rows":
        a = _rand(600, 900, seed=2).tolil()
        a[100:140, :] = 0
        a = a.tocsr()
        a.eliminate_zeros()
        kw["max_steps"] = 2
    elif case == "megahub":
        # every edge in the last stripe: 300 edges / (32 * 2) = 5 steps > 2
        rng = np.random.default_rng(4)
        a = sp.csr_matrix((np.ones(300, np.float32),
                           (rng.integers(64, 128, 300),
                            rng.integers(0, 128, 300))), shape=(128, 128))
        a.sum_duplicates()
        kw["max_steps"] = 2
    elif case == "empty_stripe":
        a = _rand(400, 800, seed=5).tolil()
        a[128:256, :] = 0  # two whole stripes of 64 rows without edges
        a = a.tocsr()
        a.eliminate_zeros()
    else:
        a = _rand(300, 1200, seed=6)
        kw["max_steps"] = 3
        slots = True
    r, c, v = _coo(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = tgs.build_gscatter_coo(r, c, v, a.shape, return_slots=slots,
                                      **kw)
        ref = jgs.build_gscatter_coo(r, c, v, a.shape, return_slots=slots,
                                     **kw)
    if slots:
        ours, s_ours = ours
        ref, s_ref = ref
        np.testing.assert_array_equal(s_ours, s_ref)
    _assert_same_tables(ours, ref)
    if case == "megahub":
        assert ours.overflow and ours.max_segment_steps <= 2
    if case == "segments_empty_rows":
        assert len(ours.segments) > 1


def test_slots_megahub_warns_like_jax():
    rng = np.random.default_rng(4)
    r, c = rng.integers(64, 128, 300), rng.integers(0, 128, 300)
    with pytest.warns(UserWarning, match="segment buffer bound"):
        gs, slots = tgs.build_gscatter_coo(
            r, c, np.ones(300, np.float32), (128, 128), tile=64, e_b=32, kb=2,
            return_slots=True, max_steps=2)
    assert not gs.overflow and len(slots) == 300


@pytest.mark.parametrize("prec,tol", [("highest", 1e-5), ("default", 1e-4)])
@pytest.mark.parametrize("case", ["plain", "megahub"])
def test_plain_matches_jax_interpret(prec, tol, case):
    if case == "plain":
        a = _rand(700, 3000, seed=1)
        kw = dict(tile=128, e_b=32, kb=4)
    else:
        rng = np.random.default_rng(4)
        a = sp.csr_matrix((rng.random(300).astype(np.float32) + 0.5,
                           (rng.integers(64, 128, 300),
                            rng.integers(0, 128, 300))), shape=(128, 128))
        a.sum_duplicates()
        kw = dict(tile=64, e_b=32, kb=2, max_steps=2)
    r, c, v = _coo(a)
    ours = tgs.build_gscatter_coo(r, c, v, a.shape, **kw)
    ref = jgs.build_gscatter_coo(r, c, v, a.shape, **kw)
    x = np.random.default_rng(0).standard_normal(
        (a.shape[1], 48)).astype(np.float32)
    got = tgs.gscatter_spmm_plain(ours, torch.from_numpy(x),
                                  precision=prec).numpy()
    want = np.asarray(jgs.gscatter_spmm(ref, jnp.asarray(x), precision=prec,
                                        interpret=True))
    for ref_out in (want, a @ x):
        if prec == "highest":
            np.testing.assert_allclose(got, ref_out, rtol=tol, atol=tol)
        else:
            # the error scales with the output, as in test_gscatter; the
            # f32 dense product does not round x to bf16
            err = np.abs(got - ref_out).max() / np.abs(ref_out).max()
            assert err < (tol if ref_out is want else 1e-2), err


def test_wrapper_takes_plain_version_on_cpu_only():
    a = _rand(300, 900, seed=7)
    rm = tgs.build_row_major(a.indptr,
                             torch.from_numpy(a.indices.astype(np.int32)),
                             torch.from_numpy(a.data), a.shape[1], budget=64)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 20)).astype(np.float32))
    before = tracing.counter("launches.gscatter_spmm")
    got = tgs.gscatter_spmm(rm, x)
    # no kernel on the CPU
    assert tracing.counter("launches.gscatter_spmm") == before
    torch.testing.assert_close(got, tgs.gscatter_rows_plain(rm, x))
    # the same sum as the chunk tables of the JAX package's layout
    torch.testing.assert_close(got, tgs.gscatter_spmm_plain(
        tgs.build_gscatter(a, tile=64, e_b=32, kb=2), x))
    with pytest.raises(ValueError, match="unsupported device"):
        tgs.gscatter_spmm(rm, x.to("meta"))


def _check_schedule(chunk_ptr, budget):
    item_ptr, item_stripe = tgs.build_schedule(chunk_ptr, budget)
    ptr = np.asarray(chunk_ptr)
    # every chunk exactly once, in order; no item over its budget
    assert item_ptr[0] == 0 and item_ptr[-1] == ptr[-1]
    sizes = np.diff(item_ptr)
    assert (sizes > 0).all() and (sizes <= budget).all()
    assert len(item_stripe) == len(sizes)
    # each item starts in the stripe it names
    np.testing.assert_array_equal(
        item_stripe, np.searchsorted(ptr, item_ptr[:-1], side="right") - 1)
    # an item packs whole stripes or lies inside one
    for lo, hi, s in zip(item_ptr[:-1], item_ptr[1:], item_stripe):
        last = np.searchsorted(ptr, hi, side="left")
        assert ptr[s] == lo or hi <= ptr[s + 1]
        assert hi == ptr[last] or last - 1 == s
    return item_ptr, item_stripe


@pytest.mark.parametrize("budget", [1, 3, 8, 40, 1000])
def test_schedule_covers_every_chunk_once(budget):
    # a hub stripe beside light ones and stripes of fillers only
    a = _rand(700, 3000, seed=1).tolil()
    a[0:64, :] = sp.random(64, 700, density=0.5, random_state=0)
    a[300:500, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    gs = tgs.build_gscatter(a, tile=64, e_b=32, kb=2)
    seg = gs.segments[0]
    ptr = seg.chunk_ptr.numpy()
    item_ptr, item_stripe = _check_schedule(ptr, budget)
    counts = np.diff(ptr)
    assert counts[0] > 8  # the hub stripe
    # every stripe, the filler-only ones included, is reached by an item
    reached = np.zeros(len(counts), bool)
    for lo, hi in zip(item_ptr[:-1], item_ptr[1:]):
        s0 = np.searchsorted(ptr, lo, side="right") - 1
        s1 = np.searchsorted(ptr, hi, side="left")
        reached[s0:s1] = True
    assert reached.all()
    if budget < counts[0]:
        # the hub stripe is cut into near-equal items of its own
        hub = np.diff(item_ptr)[item_stripe == 0]
        assert len(hub) == -(-counts[0] // budget)
        assert hub.max() - hub.min() <= 1


def test_schedule_of_every_segment_and_level():
    rng = np.random.default_rng(4)
    r, c = rng.integers(64, 128, 300), rng.integers(0, 128, 300)
    gs = tgs.build_gscatter_coo(r, c, np.ones(300, np.float32), (200, 128),
                                tile=64, e_b=32, kb=2, max_steps=2)
    assert gs.overflow
    for level in (gs,) + gs.overflow:
        for seg in level.segments:
            for budget in (1, 2, 5):
                _check_schedule(seg.chunk_ptr.numpy(), budget)


def test_feat_width_fits_shared_memory():
    assert tgs.feat_width(128, 128) == tgs.FEAT_WIDTH
    assert tgs.feat_width(512, 45) == 64 and tgs.feat_width(512, 20) == 32
    assert tgs.feat_width(256, 128, widest=128) == 128
    # 512 x 128 f32 is past the 227 KB a block can have
    assert tgs.feat_width(512, 128, widest=128) == 64
    assert tgs.feat_width(1024, 128) == 32

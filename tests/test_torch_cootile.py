"""COO-tile tables and SpMM of the PyTorch port against the JAX package.

The port's build_cootile must produce the JAX package's tables value for
value: the JAX tables concatenated over their segments (tile rows offset by
each segment's ``rb_lo``), at the same explicit (tile, e_b, kb).
cootile_spmm_plain is held against the JAX Pallas kernel run in interpret
mode: at 1e-5 of the output's scale in "highest" (both f32-faithful; the
sums run in another order) and at 1e-4 in "default", where both read x in
bf16 and round each weighted product to bf16 before the f32 sum. ``spmm``
through ``backend="cootile"`` is held against the JAX ``spmm``, forward and
gradient, at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import h2gcn_tpu.sparse.pallas_cootile as jct
from h2gcn_tpu.sparse import SparseMatrix as JSparseMatrix
from h2gcn_tpu.sparse import spmm as jspmm
from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
from h2gcn_tpu_torch.sparse import cootile as tct


def _rand(n, m, nnz, seed, rows=None):
    """Random weights in [0.5, 1.5) on ``nnz`` draws; ``rows`` limits the
    rows that hold entries."""
    rng = np.random.default_rng(seed)
    lo, hi = rows if rows is not None else (0, n)
    a = sp.csr_matrix((rng.random(nnz).astype(np.float32) + 0.5,
                       (rng.integers(lo, hi, nnz), rng.integers(0, m, nnz))),
                      shape=(n, m))
    a.sum_duplicates()
    return a


def _jax_tables(jc):
    """The JAX CooTile's segments as one table set, tile rows global."""
    segs = jc.segments
    ctr = np.concatenate([np.asarray(s.ctr) + s.rb_lo for s in segs])
    out = {"ctr": ctr}
    for name in ("ctc", "rows", "cols", "vals"):
        out[name] = np.concatenate([np.asarray(getattr(s, name))
                                    for s in segs])
    return out


# (n, m, nnz, tile, e_b, kb, rows, max_chunks): square; n and m not
# multiples of the tile (rectangular); an empty band of tile rows (entries
# only in rows 0-499); a hyper-sparse matrix with e_b chosen from it;
# kb = 1, the card's tables; JAX's segments cut small
TABLE_CASES = [
    ("square", 700, 700, 9000, 128, 64, 8, None, None),
    ("ragged", 1300, 900, 12000, 256, 32, 4, None, None),
    ("empty_band", 1200, 1200, 8000, 128, 64, 8, (0, 500), None),
    ("hyper_sparse", 3000, 3000, 900, 256, None, 8, None, None),
    ("kb1", 600, 800, 7000, 128, 128, 1, None, None),
    ("segments", 1000, 1000, 20000, 128, 32, 8, None, 64),
]


@pytest.mark.parametrize("case", TABLE_CASES, ids=lambda c: c[0])
def test_tables_identical(case, monkeypatch):
    name, n, m, nnz, tile, e_b, kb, rows, max_chunks = case
    a = _rand(n, m, nnz, 1, rows=rows)
    if max_chunks:
        monkeypatch.setattr(jct, "_MAX_CHUNKS", max_chunks)
    jc = jct.build_cootile(a, tile=tile, e_b=e_b, kb=kb)
    if max_chunks:
        assert len(jc.segments) > 1
    tc = tct.build_cootile(a, tile=tile, e_b=e_b, kb=kb)
    assert (tc.tile, tc.e_b, tc.kb, tc.n_rows, tc.n_cols) == (
        jc.tile, jc.e_b, jc.kb, jc.n_rows, jc.n_cols)
    if name == "hyper_sparse":
        assert tc.e_b == 128
    ref = _jax_tables(jc)
    for key, want in ref.items():
        got = getattr(tc, key).numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    # tile row r owns chunks row_ptr[r]:row_ptr[r + 1], at least one each
    ptr = tc.row_ptr.numpy()
    n_rb = -(-n // tile)
    assert ptr.shape == (n_rb + 1,) and ptr[0] == 0
    assert ptr[-1] == tc.num_chunks and (np.diff(ptr) >= 1).all()
    np.testing.assert_array_equal(
        np.repeat(np.arange(n_rb), np.diff(ptr)), tc.ctr.numpy())
    if name == "empty_band":
        # rows from 500 on hold no entry: their tile rows hold only
        # zero-valued fillers
        band = tc.vals.numpy()[ptr[-(-500 // tile)]:]
        assert band.size and not band.any()


@pytest.fixture(scope="module")
def kernel_cases():
    """(tables built by both packages, x) at the shapes the interpret-mode
    kernel is held at, with the JAX kernel's outputs for both precisions
    (one interpret-mode run per case and precision)."""
    cases = []
    for (n, m, nnz, tile, e_b, f, seed) in ((300, 300, 1800, 128, 64, 64, 2),
                                            (260, 390, 2500, 128, 32, 7, 3)):
        a = _rand(n, m, nnz, seed)
        x = np.random.default_rng(seed).standard_normal((m, f)).astype(
            np.float32)
        jc = jct.build_cootile(a, tile=tile, e_b=e_b, kb=8)
        tc = tct.build_cootile(a, tile=tile, e_b=e_b, kb=8)
        ref = {p: np.asarray(jct.cootile_spmm(jc, jnp.asarray(x),
                                              precision=p, interpret=True))
               for p in ("highest", "default")}
        cases.append((a, tc, x, ref))
    return cases


@pytest.mark.parametrize("precision,rel", [("highest", 1e-5),
                                           ("default", 1e-4)])
def test_plain_matches_jax_interpret(kernel_cases, precision, rel):
    for a, tc, x, ref in kernel_cases:
        got = tct.cootile_spmm_plain(tc, torch.from_numpy(x),
                                     precision=precision).numpy()
        assert got.shape == ref[precision].shape == (a.shape[0], x.shape[1])
        scale = max(1.0, float(np.abs(ref[precision]).max()))
        np.testing.assert_allclose(got, ref[precision], rtol=0,
                                   atol=rel * scale)
        if precision == "highest":
            # and the product of the matrix itself
            np.testing.assert_allclose(got, a @ x, rtol=0, atol=rel * scale)


def test_default_precision_rounds_the_product():
    """bf16 x, the product rounded to bf16, f32 sums: a value that bf16
    cannot hold shows the rounding on both sides of the product."""
    a = sp.csr_matrix(np.array([[1.0 / 3.0, 0.0], [0.0, 1.0]], np.float32))
    x = torch.tensor([[3.0], [1.0 + 2.0 ** -10]])
    tc = tct.build_cootile(a, tile=128, e_b=32)
    got = tct.cootile_spmm_plain(tc, x, precision="default")
    xb = x.to(torch.bfloat16).float()  # 1 + 2^-10 -> 1 in bf16
    want = (torch.tensor([[1.0 / 3.0], [1.0]]) * xb).to(
        torch.bfloat16).float()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    full = tct.cootile_spmm_plain(tc, x, precision="highest")
    assert float(full[1, 0]) == pytest.approx(1.0 + 2.0 ** -10, abs=0)


@pytest.mark.parametrize("symmetric", [True, False])
def test_spmm_forward_and_gradient_match_jax(symmetric):
    a = _rand(700, 700, 8000, 4)
    if symmetric:
        a = (a + a.T).tocsr()
    sm = SparseMatrix.from_scipy(a, backend="cootile")
    assert sm.backend == "cootile" and sm.symmetric == symmetric
    assert (sm.coot_t is None) == symmetric
    assert sm.coot.tile == tct.DEFAULT_TILE and sm.coot.kb == 1
    # the JAX package's cootile backend runs its segment path on the CPU
    jsm = JSparseMatrix.from_scipy(a, backend="segment")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((700, 64)).astype(np.float32)
    g = rng.standard_normal((700, 64)).astype(np.float32)
    jy, vjp = jax.vjp(lambda v: jspmm(jsm, v), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = spmm(sm, xt)
    y.backward(torch.from_numpy(g))
    for got, ref in ((y.detach().numpy(), np.asarray(jy)),
                     (xt.grad.numpy(), np.asarray(jdx))):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    if not symmetric:
        # the backward read the transpose tables: A^T g, not A g
        assert not np.allclose(xt.grad.numpy(), a @ g, atol=1e-3)


def _skewed_a2(seed=5):
    """The exact-2-hop matrix of a small hub-skewed graph (chip_smoke's
    build_graph), symmetric-normalized."""
    import chip_smoke
    from h2gcn_tpu_torch.sparse import transforms

    split = transforms.nhood_split(
        chip_smoke.build_graph(n=2000, m_edges=12000, seed=seed), 2)
    return transforms.normalize(split[2]).tocsr()


def test_live_slots_run_in_row_order_within_chunks():
    """The kernel sums a run of one destination row in registers: the
    tables hold each chunk's live slots first and in non-decreasing row,
    and row_runs counts the runs."""
    a = _skewed_a2()
    ctr, ctc, rows, cols, vals, _, e_b = tct.build_chunk_tables(
        a, tile=256, e_b=None, kb=1)
    live = vals != 0
    runs = 0
    for k in range(len(ctr)):
        n_live = int(live[k].sum())
        assert live[k, :n_live].all()  # padding only at the chunk's end
        r = rows[k, :n_live]
        assert (np.diff(r) >= 0).all()
        runs += int(n_live and 1 + np.count_nonzero(np.diff(r)))
    ct = tct.build_cootile(a, tile=256)
    assert ct.e_b == e_b
    assert tct.row_runs(ct) == runs
    # a run holds several edges: the shared-memory adds they save
    assert a.nnz / runs > 3


def test_row_runs_count_any_slot_order():
    """Slots shuffled inside their chunks: the sums stay, the runs grow
    (the kernel flushes more often, and is right for any order)."""
    a = _skewed_a2(6)
    ct = tct.build_cootile(a, tile=128)
    rng = np.random.default_rng(0)
    perm = np.argsort(rng.random(tuple(ct.rows.shape)), axis=1)
    shuffled = dataclasses.replace(ct, **{
        k: torch.from_numpy(np.take_along_axis(getattr(ct, k).numpy(), perm,
                                               axis=1))
        for k in ("rows", "cols", "vals")})
    assert tct.row_runs(shuffled) > tct.row_runs(ct)
    x = torch.from_numpy(
        rng.standard_normal((a.shape[1], 16)).astype(np.float32))
    torch.testing.assert_close(tct.cootile_spmm_plain(shuffled, x),
                               tct.cootile_spmm_plain(ct, x),
                               rtol=0, atol=1e-5)


def test_feat_width_fits_shared_memory():
    from h2gcn_tpu_torch.sparse.gscatter import _MAX_SHARED, feat_width

    # one thread block covers F = 128 at the default tile
    w = feat_width(tct.DEFAULT_TILE, 128, tct.FEAT_WIDTH)
    assert w == tct.FEAT_WIDTH and tct.DEFAULT_TILE * w * 4 <= _MAX_SHARED
    # the largest tile still fits at 32 features a block
    assert tct._MAX_TILE * 32 * 4 <= _MAX_SHARED
    assert (tct._MAX_TILE + 1) * 32 * 4 > _MAX_SHARED
    assert feat_width(tct._MAX_TILE, 128) == 32


@pytest.mark.parametrize("f,width", [(128, 128), (64, 128), (128, 32)])
def test_chunk_ranges_fill_the_card(f, width):
    """One range per block and feature tile: a small matrix still gets
    over 2 blocks on each SM (4 before the ranges round up), a hub tile row
    spreads over many ranges, and no range walks past the slot budget."""
    a = _rand(2000, 2000, 200_000, 11, rows=(0, 256))
    ct = tct.build_cootile(a, tile=256, e_b=128)
    per_block = tct._chunks_per_block(ct, f, width, 132)
    ranges = -(-ct.num_chunks // per_block)
    tiles = -(-f // width)
    assert per_block * ct.e_b <= tct._SLOTS_PER_BLOCK
    assert 2 * ranges * tiles > min(4 * 132, ct.num_chunks * tiles)
    assert ct.heaviest_row_chunks() > 8 * per_block


def test_schedule_takes_pieces_only_past_l2_over_full_tables():
    """The kernel's two regimes: one piece a warp and 16,384-slot ranges
    while x fits in half the L2 or the tables are mostly padding; pieces
    of 4 groups and 65,536-slot ranges past it over tables >= 10% full."""
    l2 = 50 * 2 ** 20
    full = tct.build_cootile(_rand(2000, 2000, 200_000, 11), tile=256)
    sparse = tct.build_cootile(_rand(3000, 3000, 900, 12), tile=256, e_b=128)
    assert full.nnz == int((full.vals != 0).sum()) > 0
    assert full.nnz / (full.num_chunks * full.e_b) >= tct._MIN_FILL_PAST_L2
    assert sparse.nnz / (sparse.num_chunks * sparse.e_b) < tct._MIN_FILL_PAST_L2
    near = (0, tct._SLOTS_PER_BLOCK)
    past = (tct._PIECE_PAST_L2, tct._SLOTS_PER_BLOCK_PAST_L2)
    assert tct.schedule(full, l2 // 2, l2) == near
    assert tct.schedule(full, l2 // 2 + 1, l2) == past
    assert tct.schedule(sparse, 4 * l2, l2) == near

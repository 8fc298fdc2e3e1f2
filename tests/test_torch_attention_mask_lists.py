"""The BSR attention's column pass over per-column edge lists, on the CPU.

``gat_bwd_col`` launches the item kernel of ``csrc/gat_attention_col.cu``
over per-column lists built once from the mask's own entries > 0
(``mask_col_lists``) and their work items (``mask_col_items``). These tests
hold the lists against the mask's entries (each column's rows as a set,
rows ascending, empty and padding columns empty, a mask whose entries are
not all 1, built once and kept on the BSR), and a walk of the items in
numpy, split columns summed in piece order as the kernel's merge sums them,
against ``gat_bwd_col_plain`` at 1e-5 of the output's scale (both sum in
f32, in another order and association)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.sparse import attention as tatt
from h2gcn_tpu_torch.sparse import edge_items as tei
from h2gcn_tpu_torch.sparse.matrix import _build_bsr


def _mask(n, B, seed, hub_edges=0, empty=True):
    """A symmetric self-looped mask with block row and column 1 empty (its
    filler blocks only); node 0 links to ``hub_edges`` nodes both ways."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.03, random_state=seed, format="csr")
    a = ((a + a.T + sp.eye(n)) > 0).astype(np.float32).tolil()
    if hub_edges:
        nb = rng.choice(np.arange(2 * B, n), min(hub_edges, n - 2 * B),
                        replace=False)
        a[0, nb] = 1
        a[nb, 0] = 1
    if empty:
        a[B:2 * B, :] = 0
        a[:, B:2 * B] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _entries(bsr):
    """The mask's (row, column) pairs with an entry > 0, from its blocks."""
    B = bsr.block_size
    blocks = bsr.blocks.numpy()
    pairs = set()
    for b in range(bsr.num_blocks):
        il, jl = np.nonzero(blocks[b] > 0)
        r0 = int(bsr.block_rows[b]) * B
        c0 = int(bsr.block_cols[b]) * B
        pairs.update(zip((r0 + il).tolist(), (c0 + jl).tolist()))
    return pairs


@pytest.mark.parametrize("n,B", [(300, 128), (700, 256)])
def test_lists_hold_exactly_the_masks_entries(n, B):
    bsr = _build_bsr(_mask(n, B, 1), B)
    n_pad = bsr.n_row_blocks * B
    ptr, dst = tatt.mask_col_lists(bsr)
    assert ptr.dtype == dst.dtype == torch.int32
    assert ptr.shape == (n_pad + 1,) and int(ptr[0]) == 0
    ptr, dst = ptr.numpy().astype(np.int64), dst.numpy()
    assert ptr[-1] == len(dst)
    want = _entries(bsr)
    got = set()
    for j in range(n_pad):
        rows = dst[ptr[j]:ptr[j + 1]]
        assert (np.diff(rows) > 0).all()  # ascending, each row once
        got.update((int(i), j) for i in rows)
    assert got == want and len(dst) == len(want)
    # block column 1 and the padding columns have no entry
    deg = np.diff(ptr)
    assert (deg[B:2 * B] == 0).all() and (deg[n:] == 0).all()
    assert deg[:B].sum() > 0


def test_lists_take_entries_above_zero_whatever_their_value():
    """A weighted mask: entries of 0.25 and 3 are edges, negative ones are
    not, as ``> 0`` decides in the plain version and the JAX kernel."""
    a = _mask(300, 128, 2).tocoo()
    rng = np.random.default_rng(2)
    vals = rng.choice([0.25, 3.0, -1.0], size=a.nnz)
    w = sp.csr_matrix((vals.astype(np.float32), (a.row, a.col)),
                      shape=a.shape)
    bsr = _build_bsr(w, 128)
    ptr, dst = (t.numpy().astype(np.int64) for t in tatt.mask_col_lists(bsr))
    key = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    got = set(zip(dst.tolist(), key.tolist()))
    keep = vals > 0
    assert got == set(zip(a.row[keep].tolist(), a.col[keep].tolist()))
    assert 0 < len(got) < a.nnz


def test_lists_and_items_are_built_once_and_kept_on_the_bsr():
    bsr = _build_bsr(_mask(300, 128, 3), 128)
    assert not bsr.schedules
    lists = tatt.mask_col_lists(bsr)
    assert tatt.mask_col_lists(bsr) is lists
    it = tatt.mask_col_items(bsr)
    assert tatt.mask_col_items(bsr) is it
    assert (it.kind, it.budget, it.row_cost) == ("col", tei.EDGE_BUDGET,
                                                 tei.ROW_COST)
    other = tatt.mask_col_items(bsr, 8)
    assert other is not it and other.budget == 8
    # one scan of the mask builds the row pass's lists too
    assert set(bsr.schedules) == {"gat_col_lists", "gat_row_lists",
                                  ("col", tei.EDGE_BUDGET, tei.ROW_COST),
                                  ("col", 8, tei.ROW_COST)}
    # the items cover every column, padding included
    covered = np.zeros(bsr.n_col_blocks * 128, np.int64)
    for lo, hi, _, _ in other.items.numpy()[other.slot.numpy() < 0]:
        covered[lo:hi] += 1
    covered[other.split_rows.numpy()] += 1
    assert (covered == 1).all()


def _walk_col(ptr, dst, it, f1, f2, h, g, m, l, d, H, F, slope=0.2):
    """What the column kernel computes, item by item in f32 numpy: per
    column (or piece) dh = sum_i alpha g_i and df2 = sum_c h_j[c] (sum_i w
    g_i[c]) - sum_i w D_i, w = alpha * leaky'; pieces summed in order."""
    n_pad = len(ptr) - 1
    dh = np.zeros((n_pad, H * F), np.float32)
    df2 = np.zeros((n_pad, H), np.float32)
    parts = {}
    for (lo, hi, e_lo, e_hi), s in zip(it.items.numpy(), it.slot.numpy()):
        for j in range(lo, hi):
            i = dst[max(ptr[j], e_lo):min(ptr[j + 1], e_hi)]
            pre = f1[i] + f2[j]
            alpha = (np.exp(np.where(pre >= 0, pre, slope * pre) - m[i])
                     / np.maximum(l[i], 1e-16))
            w = np.where(pre >= 0, alpha, slope * alpha)
            gi = g[i].reshape(-1, H, F)
            part_dh = np.einsum("ek,ekf->kf", alpha, gi).ravel()
            dw = np.einsum("ek,ekf->kf", w, gi)
            part_df2 = ((h[j].reshape(H, F) * dw).sum(1)
                        - (w * d[i]).sum(0))
            if s >= 0:
                parts.setdefault(j, []).append((s, part_dh, part_df2))
            else:
                dh[j], df2[j] = part_dh, part_df2
    assert sorted(parts) == sorted(it.split_rows.tolist())
    for j, ps in parts.items():
        ps.sort(key=lambda p: p[0])
        dh[j] = np.sum([p[1] for p in ps], 0, dtype=np.float32)
        df2[j] = np.sum([p[2] for p in ps], 0, dtype=np.float32)
    return dh, df2


@pytest.mark.parametrize("n,B,H,F,budget", [(900, 256, 8, 8, None),
                                            (900, 256, 1, 7, 16),
                                            (300, 128, 3, 5, 4)])
def test_items_walked_give_the_plain_column_pass(n, B, H, F, budget):
    bsr = _build_bsr(_mask(n, B, 4, hub_edges=200), B)
    n_pad = bsr.n_row_blocks * B
    it = tatt.mask_col_items(bsr, budget)
    assert it.n_split > 0 and 0 in it.split_rows.tolist()  # the hub
    rng = np.random.default_rng(5)
    f1, f2 = (rng.standard_normal((n_pad, H)).astype(np.float32)
              for _ in range(2))
    h, g = (rng.standard_normal((n_pad, H * F)).astype(np.float32)
            for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    t = [torch.from_numpy(x) for x in (f1, f2, h, g)]
    out, m, l = tatt.gat_fwd_stats_plain(bsr, *t[:3], **kw)
    d = tatt.head_dots(t[3], out, H, F)
    want = tatt.gat_bwd_col_plain(bsr, *t, m, l, d, **kw)
    ptr, dst = (x.numpy().astype(np.int64) for x in tatt.mask_col_lists(bsr))
    got = _walk_col(ptr, dst, it, f1, f2, h, g, m.numpy(), l.numpy(),
                    d.numpy(), H, F)
    no_edge = np.diff(ptr) == 0
    assert no_edge[B:2 * B].all() and no_edge[n:].all()
    for x, y in zip(got, want):
        y = y.numpy()
        assert (x[no_edge] == 0).all() and (y[no_edge] == 0).all()
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(y).max()))


def test_cpu_wrapper_takes_the_plain_version_and_builds_no_lists():
    bsr = _build_bsr(_mask(300, 128, 6), 128)
    n_pad = bsr.n_row_blocks * 128
    H, F = 2, 4
    gen = torch.Generator().manual_seed(0)
    f1, f2, m, l, d = (torch.randn(n_pad, H, generator=gen)
                       for _ in range(5))
    h, g = (torch.randn(n_pad, H * F, generator=gen) for _ in range(2))
    before = tracing.counter("launches.gat_bwd_col")
    got = tatt.gat_bwd_col(bsr, f1, f2, h, g, m, l.abs(), d, num_heads=H,
                           feat=F)
    want = tatt.gat_bwd_col_plain(bsr, f1, f2, h, g, m, l.abs(), d,
                                  num_heads=H, feat=F)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tracing.counter("launches.gat_bwd_col") == before
    assert not bsr.schedules

"""The BSR attention's forward and row pass over per-row edge lists, on the
CPU.

``gat_fwd_stats`` and ``gat_bwd_row`` launch the item kernels of
``csrc/gat_attention_coo.cu`` over per-row lists built once from the mask's
own entries > 0 (``mask_row_lists``), from the same scan as the column
pass's lists, and their work items (``mask_row_items``). These tests hold
the lists against the mask's entries (each row's sources as a set, sources
ascending, empty and padding rows empty, a mask whose entries are not all
1, one scan for both kinds, built once and kept on the BSR), and a walk of
the items in numpy, a split row's pieces merged as the kernels merge them
(the forward rescales each piece by exp(m_p - m), df1 sums the pieces in
piece order), against ``gat_fwd_stats_plain`` and ``gat_bwd_row_plain`` at
1e-5 of the output's scale (both sum in f32, in another order and
association), and once against the JAX package's kernels in interpret
mode at the tolerances of ``tests/test_torch_attention.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu.sparse.matrix import _build_bsr as j_build_bsr
from h2gcn_tpu.sparse.pallas_attention import (_fwd_stats_call,
                                               _pad_attn_inputs,
                                               gat_attention)
from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.sparse import attention as tatt
from h2gcn_tpu_torch.sparse import edge_items as tei
from h2gcn_tpu_torch.sparse.matrix import _build_bsr

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


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
def test_row_lists_hold_exactly_the_masks_entries(n, B):
    bsr = _build_bsr(_mask(n, B, 1), B)
    n_pad = bsr.n_row_blocks * B
    ptr, src = tatt.mask_row_lists(bsr)
    assert ptr.dtype == src.dtype == torch.int32
    assert ptr.shape == (n_pad + 1,) and int(ptr[0]) == 0
    ptr, src = ptr.numpy().astype(np.int64), src.numpy()
    assert ptr[-1] == len(src)
    want = _entries(bsr)
    got = set()
    for i in range(n_pad):
        cols = src[ptr[i]:ptr[i + 1]]
        assert (np.diff(cols) > 0).all()  # ascending, each column once
        got.update((i, int(j)) for j in cols)
    assert got == want and len(src) == len(want)
    # block row 1 (filler blocks only) and the padding rows have no entry
    deg = np.diff(ptr)
    assert (deg[B:2 * B] == 0).all() and (deg[n:] == 0).all()
    assert deg[:B].sum() > 0


def test_row_lists_take_entries_above_zero_whatever_their_value():
    """A weighted mask: entries of 0.25 and 3 are edges, negative ones are
    not, as ``> 0`` decides in the plain version and the JAX kernel."""
    a = _mask(300, 128, 2).tocoo()
    rng = np.random.default_rng(2)
    vals = rng.choice([0.25, 3.0, -1.0], size=a.nnz)
    w = sp.csr_matrix((vals.astype(np.float32), (a.row, a.col)),
                      shape=a.shape)
    bsr = _build_bsr(w, 128)
    ptr, src = (t.numpy().astype(np.int64) for t in tatt.mask_row_lists(bsr))
    key = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    got = set(zip(key.tolist(), src.tolist()))
    keep = vals > 0
    assert got == set(zip(a.row[keep].tolist(), a.col[keep].tolist()))
    assert 0 < len(got) < a.nnz


def test_row_and_column_lists_come_from_one_scan_of_the_mask(monkeypatch):
    bsr = _build_bsr(_mask(300, 128, 3, hub_edges=60), 128)
    scans = []
    nonzero = torch.nonzero

    def counted(*args, **kw):
        scans.append(1)
        return nonzero(*args, **kw)

    monkeypatch.setattr(torch, "nonzero", counted)
    rows = tatt.mask_row_lists(bsr)
    cols = tatt.mask_col_lists(bsr)
    assert len(scans) == 1
    assert tatt.mask_row_lists(bsr) is rows and tatt.mask_col_lists(bsr) is cols
    # the two kinds hold the same edges
    pr, sr = (t.numpy().astype(np.int64) for t in rows)
    pc, dc = (t.numpy().astype(np.int64) for t in cols)
    by_row = set(zip(np.repeat(np.arange(len(pr) - 1), np.diff(pr)).tolist(),
                     sr.tolist()))
    by_col = set(zip(dc.tolist(),
                     np.repeat(np.arange(len(pc) - 1), np.diff(pc)).tolist()))
    assert by_row == by_col == _entries(bsr)


def test_row_items_are_built_once_and_kept_on_the_bsr():
    bsr = _build_bsr(_mask(300, 128, 3), 128)
    assert not bsr.schedules
    it = tatt.mask_row_items(bsr)
    assert tatt.mask_row_items(bsr) is it
    assert (it.kind, it.budget, it.row_cost) == ("fwd", tei.EDGE_BUDGET,
                                                 tei.ROW_COST)
    other = tatt.mask_row_items(bsr, 8)
    assert other is not it and other.budget == 8
    col = tatt.mask_col_items(bsr)
    assert col.kind == "col" and col is not it
    assert set(bsr.schedules) == {"gat_row_lists", "gat_col_lists",
                                  ("fwd", tei.EDGE_BUDGET, tei.ROW_COST),
                                  ("fwd", 8, tei.ROW_COST),
                                  ("col", tei.EDGE_BUDGET, tei.ROW_COST)}
    # the items cover every row, padding included
    covered = np.zeros(bsr.n_row_blocks * 128, np.int64)
    for lo, hi, _, _ in other.items.numpy()[other.slot.numpy() < 0]:
        covered[lo:hi] += 1
    covered[other.split_rows.numpy()] += 1
    assert (covered == 1).all()


def _leaky(x, slope):
    return np.where(x >= 0, x, slope * x)


def _pieces(ptr, src, it):
    """(row, sources, slot) of each row or piece the items walk."""
    for (lo, hi, e_lo, e_hi), s in zip(it.items.numpy(), it.slot.numpy()):
        for i in range(lo, hi):
            yield i, src[max(ptr[i], e_lo):min(ptr[i + 1], e_hi)], s


def _walk_fwd(ptr, src, it, f1, f2, h, H, F, slope=0.2):
    """What the forward kernel computes, item by item in f32 numpy: per row
    (or piece) m_p, l_p and acc_p = sum_j exp(e - m_p) h_j; a split row's
    pieces rescaled by exp(m_p - m) and summed in piece order."""
    n_pad = len(ptr) - 1
    out = np.zeros((n_pad, H * F), np.float32)
    m = np.full((n_pad, H), tatt.NEG_INF, np.float32)
    l = np.zeros((n_pad, H), np.float32)
    parts = {}
    for i, j, s in _pieces(ptr, src, it):
        if j.size == 0:
            assert s < 0
            continue
        e = _leaky(f1[i] + f2[j], slope)
        mp = e.max(0)
        p = np.exp(e - mp)
        acc = np.einsum("ek,ekf->kf", p, h[j].reshape(-1, H, F))
        if s >= 0:
            parts.setdefault(i, []).append((s, mp, p.sum(0), acc))
        else:
            m[i], l[i] = mp, p.sum(0)
            out[i] = (acc / np.maximum(l[i], 1e-16)[:, None]).ravel()
    assert sorted(parts) == sorted(it.split_rows.tolist())
    for i, ps in parts.items():
        ps.sort(key=lambda q: q[0])
        m[i] = np.max([q[1] for q in ps], 0)
        sc = [np.exp(q[1] - m[i]) for q in ps]
        l[i] = np.sum([q[2] * c for q, c in zip(ps, sc)], 0, dtype=np.float32)
        acc = np.sum([q[3] * c[:, None] for q, c in zip(ps, sc)], 0,
                     dtype=np.float32)
        out[i] = (acc / np.maximum(l[i], 1e-16)[:, None]).ravel()
    return out, m, l


def _walk_row(ptr, src, it, f1, f2, h, g, m, l, d, H, F, slope=0.2):
    """What the row pass computes, item by item in f32 numpy: per row (or
    piece) df1 = sum_c g_i[c] (sum_j w h_j[c]) - D_i sum_j w, w = alpha *
    leaky'; a split row's pieces summed in piece order."""
    n_pad = len(ptr) - 1
    df1 = np.zeros((n_pad, H), np.float32)
    parts = {}
    for i, j, s in _pieces(ptr, src, it):
        pre = f1[i] + f2[j]
        alpha = (np.exp(_leaky(pre, slope) - m[i])
                 / np.maximum(l[i], 1e-16))
        w = np.where(pre >= 0, alpha, slope * alpha)
        hw = np.einsum("ek,ekf->kf", w, h[j].reshape(-1, H, F))
        part = (g[i].reshape(H, F) * hw).sum(1) - d[i] * w.sum(0)
        if s >= 0:
            parts.setdefault(i, []).append((s, part))
        else:
            df1[i] = part
    assert sorted(parts) == sorted(it.split_rows.tolist())
    for i, ps in parts.items():
        ps.sort(key=lambda q: q[0])
        df1[i] = np.sum([q[1] for q in ps], 0, dtype=np.float32)
    return df1


def _close(got, want):
    """Entries where ``want`` keeps the -1e30 sentinel match exactly; the
    others within 1e-5 of the output's scale."""
    live = want > tatt.NEG_INF / 2
    np.testing.assert_array_equal(got[~live], want[~live])
    scale = max(1.0, np.abs(want[live]).max()) if live.any() else 1.0
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=1e-5 * scale)


def _inputs(n_pad, H, F, seed):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal((n_pad, H)).astype(np.float32)
              for _ in range(2))
    h, g = (rng.standard_normal((n_pad, H * F)).astype(np.float32)
            for _ in range(2))
    return f1, f2, h, g


# (n, B, H, F, edges an item): a hub row cut into pieces beside block row 1
# without an edge, at the default budget and at smaller ones; layer 2 (1
# head of 7); more heads than a kernel pass takes (12)
WALK_CASES = [(900, 256, 8, 8, None), (900, 256, 1, 7, 16),
              (300, 128, 3, 5, 4), (600, 128, 12, 5, 32)]


@pytest.mark.parametrize("n,B,H,F,budget", WALK_CASES)
def test_row_items_walked_give_the_plain_forward_and_row_pass(n, B, H, F,
                                                              budget):
    bsr = _build_bsr(_mask(n, B, 4, hub_edges=200), B)
    n_pad = bsr.n_row_blocks * B
    it = tatt.mask_row_items(bsr, budget)
    assert it.n_split > 0 and 0 in it.split_rows.tolist()  # the hub
    f1, f2, h, g = _inputs(n_pad, H, F, 5)
    kw = dict(num_heads=H, feat=F)
    t = [torch.from_numpy(x) for x in (f1, f2, h, g)]
    want = tatt.gat_fwd_stats_plain(bsr, *t[:3], **kw)
    ptr, src = (x.numpy().astype(np.int64) for x in tatt.mask_row_lists(bsr))
    got = _walk_fwd(ptr, src, it, f1, f2, h, H, F)
    no_edge = np.diff(ptr) == 0
    assert no_edge[B:2 * B].all() and no_edge[n:].all()
    for x, y in zip(got, want):
        _close(x, y.numpy())
    out, m, l = (y.numpy() for y in want)
    assert (m[no_edge] == tatt.NEG_INF).all() and (l[no_edge] == 0).all()
    assert (out[no_edge] == 0).all()

    d = tatt.head_dots(t[3], want[0], H, F)
    df1 = tatt.gat_bwd_row_plain(bsr, *t, *want[1:], d, **kw).numpy()
    got = _walk_row(ptr, src, it, f1, f2, h, g, m, l, d.numpy(), H, F)
    _close(got, df1)
    assert (got[no_edge] == 0).all() and (df1[no_edge] == 0).all()


def test_row_items_walked_match_the_jax_kernels_in_interpret_mode():
    """The same numpy inputs through the JAX package's forward-with-stats
    kernel and ``jax.grad`` of its ``gat_attention`` (interpret mode):
    out, m and l on every padded row, and df1."""
    n, B, H, F = 400, 128, 3, 8
    a = _mask(n, B, 6, hub_edges=150)
    bsr = _build_bsr(a, B)
    n_pad = bsr.n_row_blocks * B
    it = tatt.mask_row_items(bsr, 32)
    assert it.n_split > 0
    rng = np.random.default_rng(7)
    f1, f2, h, gw = (rng.standard_normal(s).astype(np.float32)
                     for s in ((n, H), (n, H), (n, H * F), (n, H * F)))
    jb = j_build_bsr(a, B)
    jf1, jf2, jh = (jnp.asarray(x) for x in (f1, f2, h))
    j_out, j_m, j_l = _fwd_stats_call(
        jb, *_pad_attn_inputs(jb, jf1, jf2, jh, H, F), H, F, 0.2, True)
    pad = [np.zeros((n_pad, x.shape[1]), np.float32) for x in (f1, f2, h, gw)]
    for p, x in zip(pad, (f1, f2, h, gw)):
        p[:n] = x
    ptr, src = (x.numpy().astype(np.int64) for x in tatt.mask_row_lists(bsr))
    out, m, l = _walk_fwd(ptr, src, it, *pad[:3], H, F)
    np.testing.assert_allclose(out, np.asarray(j_out)[:, :H * F], **FWD)
    np.testing.assert_allclose(m, np.asarray(j_m)[:, :H], **FWD)
    np.testing.assert_allclose(l, np.asarray(j_l)[:, :H], **FWD)

    gwj = jnp.asarray(gw)
    j_df1 = jax.grad(lambda *x: jnp.sum(gat_attention(
        jb, *x, num_heads=H, feat=F, n_out=n, interpret=True) * gwj))(
            jf1, jf2, jh)
    d = (pad[3].reshape(-1, H, F) * out.reshape(-1, H, F)).sum(2)
    df1 = _walk_row(ptr, src, it, *pad, m, l, d, H, F)
    np.testing.assert_allclose(df1[:n], np.asarray(j_df1), **GRAD)
    assert (df1[n:] == 0).all()


def test_cpu_wrappers_take_the_plain_versions_and_build_no_lists():
    bsr = _build_bsr(_mask(300, 128, 8), 128)
    n_pad = bsr.n_row_blocks * 128
    H, F = 2, 4
    gen = torch.Generator().manual_seed(0)
    f1, f2, d = (torch.randn(n_pad, H, generator=gen) for _ in range(3))
    h, g = (torch.randn(n_pad, H * F, generator=gen) for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    before = (tracing.counter("launches.gat_fwd_stats"),
              tracing.counter("launches.gat_bwd_row"))
    got = tatt.gat_fwd_stats(bsr, f1, f2, h, **kw)
    want = tatt.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    df1 = tatt.gat_bwd_row(bsr, f1, f2, h, g, *want[1:], d, **kw)
    assert torch.equal(df1, tatt.gat_bwd_row_plain(bsr, f1, f2, h, g,
                                                   *want[1:], d, **kw))
    assert (tracing.counter("launches.gat_fwd_stats"),
            tracing.counter("launches.gat_bwd_row")) == before
    assert not bsr.schedules

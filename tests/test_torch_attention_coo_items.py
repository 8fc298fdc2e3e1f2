"""The COO-chunk attention's per-row edge lists and work items, on the CPU.

The forward and the row pass (``csrc/gat_attention_coo.cu``) and the column
pass (``csrc/gat_attention_col.cu``) walk per-row (per-column) edge lists
sorted once from the chunk tables, in work items of at most ``budget``
edges; a longer row is cut into pieces whose partial states are merged.
These tests hold the lists against the tables' own edges (``coo_edges``),
the items against their contract (every row once, no item past its budget,
hubs cut into near-equal pieces, empty and padding rows covered, the same
items every build), and walks of the items in numpy, merged as the kernels
merge split rows, against a float64 softmax and row gradient row by row at
1e-5 of the output's scale (the walks sum in f32, in another order and,
for the row pass, another association). The plain versions sum in float64,
so their results do not depend on the CPU's threads."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch.sparse import attention_coo as tac

N, H, F, TILE, E_B = 520, 2, 8, 128, 32


def _support():
    """test_torch_attention_coo.py's asymmetric support (n = 520, density
    0.02, self loops, rows 140-199 and columns 300-339 emptied)."""
    a = sp.random(N, N, density=0.02, random_state=1, format="csr")
    a = ((a > 0).astype(np.float32) + sp.eye(N, dtype=np.float32)).tolil()
    a[140:200, :] = 0
    a[:, 300:340] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _star(n, hub_edges):
    """Node 0 links to ``hub_edges`` nodes, both ways; self loops."""
    rng = np.random.default_rng(4)
    nb = rng.choice(np.arange(1, n), hub_edges, replace=False)
    r = np.concatenate([np.zeros(hub_edges, np.int64), nb, np.arange(n)])
    c = np.concatenate([nb, np.zeros(hub_edges, np.int64), np.arange(n)])
    return sp.csr_matrix((np.ones(r.size, np.float32), (r, c)),
                         shape=(n, n))


def _pairs(dest, src):
    return sorted(zip(dest.tolist(), src.tolist()))


@pytest.mark.parametrize("max_chunks", [None, 16])
def test_edge_lists_hold_exactly_the_tables_edges(max_chunks):
    ac = tac.build_attn_coo(_support(), tile=TILE, e_b=E_B,
                            max_chunks=max_chunks)
    if max_chunks:
        assert len(ac.fwd) > 1 and len(ac.bwd) > 1
    n_pad = ac.n_tiles * TILE
    for ptr, other, segs, transpose in (
            (ac.fwd_ptr, ac.fwd_src, ac.fwd, False),
            (ac.col_ptr, ac.col_dst, ac.bwd, True)):
        assert ptr.dtype == other.dtype == torch.int32
        assert ptr.shape == (n_pad + 1,) and int(ptr[0]) == 0
        key = np.repeat(np.arange(n_pad), np.diff(ptr.numpy()))
        dest, src = tac.coo_edges(segs, TILE, transpose=transpose)
        want = _pairs(dest.numpy(), src.numpy())
        got = (_pairs(key, other.numpy()) if not transpose
               else _pairs(other.numpy(), key))
        assert got == want  # each edge once, no other
        assert len(set(got)) == len(got) == _support().nnz


@pytest.mark.parametrize("budget", [1, 7, 64, 100_000])
def test_items_cover_every_row_once_within_budget(budget):
    ac = tac.build_attn_coo(_support(), tile=TILE, e_b=E_B)
    ptr = ac.fwd_ptr.numpy().astype(np.int64)
    items, slot, split_rows, split_ptr = tac.build_edge_items(ptr, budget)
    n_pad = len(ptr) - 1
    lo, hi, e_lo, e_hi = items.T.astype(np.int64)
    assert (e_hi - e_lo <= budget).all()
    assert (hi - lo >= 1).all() and (hi - lo <= tac._MAX_ITEM_ROWS).all()
    # each row costs ROW_COST edges: only a lone row may pass the budget
    cost = e_hi - e_lo + tac.ROW_COST * (hi - lo)
    assert (cost[hi - lo > 1] <= budget).all()
    # rows in order, each in one item, or in consecutive pieces of one row
    whole = slot < 0
    covered = np.zeros(n_pad, np.int64)
    for a, b in zip(lo[whole], hi[whole]):
        covered[a:b] += 1
        assert e_lo[whole][lo[whole] == a][0] == ptr[a]
    covered[split_rows] += 1
    assert (covered == 1).all()
    assert (np.diff(lo) >= 0).all()
    # a split row's pieces tile its edges, in slot order
    assert np.array_equal(slot[~whole], np.arange(split_ptr[-1]))
    for s, r in enumerate(split_rows):
        pieces = np.flatnonzero(~whole & (lo == r))
        assert np.array_equal(slot[pieces],
                              np.arange(split_ptr[s], split_ptr[s + 1]))
        assert e_lo[pieces[0]] == ptr[r] and e_hi[pieces[-1]] == ptr[r + 1]
        assert np.array_equal(e_lo[pieces[1:]], e_hi[pieces[:-1]])
        assert np.diff(ptr)[r] > budget


def test_star_hub_is_cut_into_near_equal_pieces():
    budget = 64
    a = _star(2000, 5 * budget + 3)
    ac = tac.build_attn_coo(a, tile=256)
    for kind in ("fwd", "col"):
        it = tac.edge_items(ac, kind, budget)
        items, slot = it.items.numpy(), it.slot.numpy()
        assert it.split_rows.tolist() == [0]
        pieces = items[slot >= 0]
        assert len(pieces) >= 5 and (pieces[:, 0] == 0).all()
        sizes = pieces[:, 3] - pieces[:, 2]
        assert sizes.sum() == 5 * budget + 4  # its edges and its self loop
        assert sizes.max() - sizes.min() <= 1 and sizes.max() <= budget
        assert it.n_pieces == len(pieces)


def test_empty_and_padding_rows_are_covered():
    a = _support()  # rows 140-199 and columns 300-339 have no edge
    ac = tac.build_attn_coo(a, tile=TILE, e_b=E_B)
    n_pad = ac.n_tiles * TILE
    assert n_pad > N
    for kind, empty in (("fwd", range(140, 200)), ("col", range(300, 340))):
        it = tac.edge_items(ac, kind, 16)
        items = it.items.numpy()
        rows = np.zeros(n_pad, bool)
        for lo, hi, _, _ in items:
            rows[lo:hi] = True
        rows[it.split_rows.numpy()] = True
        assert rows[list(empty)].all() and rows[N:].all() and rows.all()
        ptr = (ac.fwd_ptr if kind == "fwd" else ac.col_ptr).numpy()
        assert (np.diff(ptr)[list(empty)] == 0).all()
        assert (np.diff(ptr)[N:] == 0).all()


def test_item_builder_is_deterministic():
    a = _support() + _star(N, 300)
    first = tac.build_attn_coo(a, tile=TILE, e_b=E_B)
    again = tac.build_attn_coo(a, tile=TILE, e_b=E_B)
    for name in ("fwd_ptr", "fwd_src", "col_ptr", "col_dst"):
        assert torch.equal(getattr(first, name), getattr(again, name))
    for key in (("fwd", tac.EDGE_BUDGET, tac.ROW_COST),
                ("col", tac.EDGE_BUDGET, tac.ROW_COST)):
        x, y = first.items[key], again.items[key]
        assert x.n_split > 0
        for name in ("items", "slot", "split_rows", "split_ptr"):
            assert torch.equal(getattr(x, name), getattr(y, name))


def test_items_are_built_once_and_kept_on_the_payload():
    ac = tac.build_attn_coo(_support(), tile=TILE, e_b=E_B)
    assert set(ac.items) == {("fwd", tac.EDGE_BUDGET, tac.ROW_COST),
                             ("col", tac.EDGE_BUDGET, tac.ROW_COST)}
    it = tac.edge_items(ac, "fwd")
    assert it is ac.items[("fwd", tac.EDGE_BUDGET, tac.ROW_COST)]
    other = tac.edge_items(ac, "col", 8)
    assert other is tac.edge_items(ac, "col", 8) and other.budget == 8
    assert (other.kind, it.kind, other.row_cost) == ("col", "fwd",
                                                     tac.ROW_COST)
    assert other.n_items > it.n_items
    # a row cost of 0 packs up to 32 rows an item: fewer items
    assert tac.edge_items(ac, "fwd", None, 0).n_items < it.n_items
    assert all(t.dtype == torch.int32 for t in (
        other.items, other.slot, other.split_rows, other.split_ptr))


def _walk_fwd(ac, it, f1, f2, h, slope=0.2):
    """What the forward kernel computes, item by item in numpy: each item's
    rows (or piece) as a softmax over its edges, pieces merged with the
    exp(m_p - m) rescaling."""
    ptr, src = ac.fwd_ptr.numpy(), ac.fwd_src.numpy()
    n_pad = len(ptr) - 1
    out = np.zeros((n_pad, H * F), np.float32)
    m = np.full((n_pad, H), tac.NEG_INF, np.float32)
    l = np.zeros((n_pad, H), np.float32)
    parts = {}
    for (lo, hi, e_lo, e_hi), s in zip(it.items.numpy(), it.slot.numpy()):
        for r in range(lo, hi):
            j = src[max(ptr[r], e_lo):min(ptr[r + 1], e_hi)]
            if not len(j):
                continue
            e = f1[r] + f2[j]
            e = np.where(e >= 0, e, slope * e)
            mr = e.max(0)
            p = np.exp(e - mr)
            acc = np.einsum("ek,ekf->kf", p, h[j].reshape(-1, H, F))
            if s >= 0:
                parts.setdefault(r, []).append((mr, p.sum(0), acc))
            else:
                m[r], l[r] = mr, p.sum(0)
                out[r] = (acc / np.maximum(l[r], 1e-16)[:, None]).ravel()
    assert sorted(parts) == sorted(it.split_rows.tolist())
    for r, ps in parts.items():
        mr = np.max([q[0] for q in ps], 0)
        sc = [np.exp(q[0] - mr) for q in ps]
        l[r] = sum(q[1] * c for q, c in zip(ps, sc))
        m[r] = mr
        acc = sum(q[2] * c[:, None] for q, c in zip(ps, sc))
        out[r] = (acc / np.maximum(l[r], 1e-16)[:, None]).ravel()
    return out, m, l


def _row_softmax(a, n_pad, f1, f2, h, slope=0.2):
    """The forward row by row from the scipy support itself, in float64:
    the reference of the walk (torch's CPU scatter-adds of the plain
    version gave sums that varied from run to run under load in a pytest
    process, up to 1.2e-3 in l)."""
    out = np.zeros((n_pad, H * F))
    m = np.full((n_pad, H), np.float32(tac.NEG_INF), np.float64)
    l = np.zeros((n_pad, H))
    for r in range(a.shape[0]):
        j = a.indices[a.indptr[r]:a.indptr[r + 1]]
        if not len(j):
            continue
        e = f1[r].astype(np.float64) + f2[j]
        e = np.where(e >= 0, e, slope * e)
        m[r] = e.max(0)
        p = np.exp(e - m[r])
        l[r] = p.sum(0)
        acc = np.einsum("ek,ekf->kf", p, h[j].reshape(-1, H, F))
        out[r] = (acc / l[r][:, None]).ravel()
    return out, m, l


@pytest.mark.parametrize("budget", [5, 64])
def test_items_walked_and_merged_give_the_row_softmax(budget):
    a = (_support() + _star(N, 300)).tocsr()
    a.sum_duplicates()
    ac = tac.build_attn_coo(a, tile=TILE, e_b=E_B)
    n_pad = ac.n_tiles * TILE
    rng = np.random.default_rng(0)
    f1, f2 = (rng.standard_normal((n_pad, H)).astype(np.float32)
              for _ in range(2))
    h = rng.standard_normal((n_pad, H * F)).astype(np.float32)
    it = tac.edge_items(ac, "fwd", budget)
    assert it.n_split > 0
    got = _walk_fwd(ac, it, f1, f2, h)
    for x, y in zip(got, _row_softmax(a, n_pad, f1, f2, h)):
        live = y > tac.NEG_INF / 2
        assert np.array_equal(x[~live], y[~live])
        scale = max(1.0, np.abs(y[live]).max())
        np.testing.assert_allclose(x[live], y[live], rtol=0,
                                   atol=1e-5 * scale)


def _walk_row(ac, it, f1, f2, h, g, m, l, d, slope=0.2):
    """What the row pass computes, item by item in f32 numpy: per row (or
    piece) df1 = sum_c g_i[c] (sum_j w_ij h_j[c]) - D_i sum_j w_ij, w =
    alpha * leaky', the row's constants read once; pieces summed in piece
    order, as the kernel's merge sums them."""
    ptr, src = ac.fwd_ptr.numpy(), ac.fwd_src.numpy()
    df1 = np.zeros((len(ptr) - 1, H), np.float32)
    parts = {}
    for (lo, hi, e_lo, e_hi), s in zip(it.items.numpy(), it.slot.numpy()):
        for r in range(lo, hi):
            j = src[max(ptr[r], e_lo):min(ptr[r + 1], e_hi)]
            pre = f1[r] + f2[j]
            alpha = (np.exp(np.where(pre >= 0, pre, slope * pre) - m[r])
                     / np.maximum(l[r], 1e-16))
            w = np.where(pre >= 0, alpha, slope * alpha)
            dw = np.einsum("ek,ekf->kf", w, h[j].reshape(-1, H, F))
            part = (g[r].reshape(H, F) * dw).sum(1) - d[r] * w.sum(0)
            if s >= 0:
                parts.setdefault(r, []).append((s, part))
            else:
                df1[r] = part
    assert sorted(parts) == sorted(it.split_rows.tolist())
    for r, ps in parts.items():
        ps.sort(key=lambda p: p[0])
        df1[r] = np.sum([p[1] for p in ps], 0, dtype=np.float32)
    return df1


def _row_df1(a, n_pad, f1, f2, h, g, m, l, d, slope=0.2):
    """df1 row by row from the scipy support, in float64:
    sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij."""
    df1 = np.zeros((n_pad, H))
    for r in range(a.shape[0]):
        j = a.indices[a.indptr[r]:a.indptr[r + 1]]
        pre = f1[r].astype(np.float64) + f2[j]
        alpha = np.exp(np.where(pre >= 0, pre, slope * pre) - m[r]) / l[r]
        gh = np.einsum("kf,ekf->ek", g[r].reshape(H, F).astype(np.float64),
                       h[j].reshape(-1, H, F))
        df1[r] = (alpha * (gh - d[r]) * np.where(pre >= 0, 1.0, slope)).sum(0)
    return df1


@pytest.mark.parametrize("budget", [5, 64])
def test_row_pass_items_walked_give_the_row_gradient(budget):
    """The row pass over the forward's items (hub rows split) against a
    float64 reference, at 1e-5 of df1's scale; rows without an edge (the
    padding rows: the star adds self loops) get exactly 0."""
    a = (_support() + _star(N, 300)).tocsr()
    a.sum_duplicates()
    ac = tac.build_attn_coo(a, tile=TILE, e_b=E_B)
    n_pad = ac.n_tiles * TILE
    rng = np.random.default_rng(1)
    f1, f2 = (rng.standard_normal((n_pad, H)).astype(np.float32)
              for _ in range(2))
    h, g = (rng.standard_normal((n_pad, H * F)).astype(np.float32)
            for _ in range(2))
    out, m, l = (x.astype(np.float32)
                 for x in _row_softmax(a, n_pad, f1, f2, h))
    d = (g.reshape(-1, H, F) * out.reshape(-1, H, F)).sum(2)
    it = tac.edge_items(ac, "fwd", budget)
    assert it.n_split > 0 and 0 in it.split_rows.tolist()  # the star row
    got = _walk_row(ac, it, f1, f2, h, g, m, l, d)
    want = _row_df1(a, n_pad, f1, f2, h, g, m, l, d)
    empty = np.diff(ac.fwd_ptr.numpy()) == 0
    assert empty[N:].all() and n_pad > N  # the padding rows
    assert (got[empty] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_coo_plain_versions_are_deterministic_across_threads():
    """The plain versions sum in float64 and round once, so their results
    do not depend on how many CPU threads their index_add_ takes."""
    a = (_support() + _star(N, 300)).tocsr()
    ac = tac.build_attn_coo(a, tile=TILE, e_b=E_B)
    n_pad = ac.n_tiles * TILE
    rng = np.random.default_rng(2)
    f1, f2 = (torch.from_numpy(rng.standard_normal((n_pad, H))
                               .astype(np.float32)) for _ in range(2))
    h, g = (torch.from_numpy(rng.standard_normal((n_pad, H * F))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    threads = torch.get_num_threads()
    runs = []
    try:
        for k in (1, 4):
            torch.set_num_threads(k)
            out, m, l = tac.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
            d = tac.head_dots(g, out, H, F)
            bwd = (ac, f1, f2, h, g, m, l, d)
            runs.append((out, m, l, tac.coo_bwd_row_plain(*bwd, **kw))
                        + tac.coo_bwd_col_plain(*bwd, **kw))
    finally:
        torch.set_num_threads(threads)
    for one, four in zip(*runs):
        live = one > tac.NEG_INF / 2
        scale = max(1.0, float(one[live].abs().max()))
        assert float((one - four).abs().max()) <= 1e-7 * scale

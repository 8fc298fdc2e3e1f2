"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs on a GPU machine without it:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``. Every
test here needs a CUDA GPU and nvcc and skips without them. Tolerance: the
kernels sum in another order than index_add_ / einsum (atomics, tiles), so
the error is held at 1e-5 of the output's scale; bf16 rounding is the same
on both sides. The GAT attention kernels also rescale their online softmax
edge by edge where the plain versions take each row's max at once, so they
are held at 1e-4 of the output's scale, the gate of chip_smoke.py; so is the
weighted gather-scatter combine of the gather attention, whose weights come
from the softmax. The COO-chunk kernels in "default" precision round their
contraction operands to bf16 at the running row max where the plain
version rounds at the final one, so they are held at 3e-2 of the output's
scale, the JAX package's bound for its bf16 mode. The COO-tile SpMM rounds
where its plain version rounds in both precisions and is held at 1e-5."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch.models import GAT as tgat
from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
from h2gcn_tpu_torch.sparse import attention as tatt
from h2gcn_tpu_torch.sparse import attention_coo as tcoo
from h2gcn_tpu_torch.sparse import attention_gather as tgat_
from h2gcn_tpu_torch.sparse import bsr_spmm as tbsr
from h2gcn_tpu_torch.sparse import cootile as tct
from h2gcn_tpu_torch.sparse import gscatter as tgs

TOL = 1e-5
GAT_TOL = 1e-4
BF16_TOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, tol=TOL):
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    # the GAT row max keeps its -1e30 sentinel exactly where a row has no
    # entry; the scale is taken over the other entries
    live = ref > tatt.NEG_INF / 2
    assert torch.equal(got[~live], ref[~live])
    scale = max(1.0, float(ref[live].abs().max()))
    err = float((got[live] - ref[live]).abs().max())
    assert err <= tol * scale, (err, scale)


def _rand(n, m, nnz, seed, rows=None):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz) if rows is None else rng.integers(*rows, nnz)
    a = sp.csr_matrix((rng.random(nnz).astype(np.float32) + 0.5,
                       (r, rng.integers(0, m, nnz))), shape=(n, m))
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", ["plain", "segments", "megahub", "ragged",
                                  "hub_items"])
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
    elif case == "ragged":
        # F not a multiple of 32, empty stripes, n not a multiple of 512
        a, f = _rand(1300, 900, 5000, 3, rows=(0, 400)), 45
    else:
        # one stripe of 80,000 edges (many work items) beside light ones:
        # segments and an overflow level
        a = (_rand(3000, 3000, 80000, 8, rows=(0, 512))
             + _rand(3000, 3000, 20000, 9)).tocsr()
        f = 128
        kw = dict(max_steps=40)
    c = a.tocoo()
    gs = tgs.build_gscatter_coo(c.row, c.col, c.data, a.shape, device=cuda,
                                **kw)
    if case in ("megahub", "hub_items"):
        assert gs.overflow
    x = torch.randn(a.shape[1], f, device=cuda)
    before = tgs.gscatter_spmm.launches
    got = tgs.gscatter_spmm(gs, x, precision=precision)
    torch.cuda.synchronize()
    levels = (gs,) + gs.overflow
    assert tgs.gscatter_spmm.launches - before == sum(
        len(lv.segments) for lv in levels)
    _close(got, tgs.gscatter_spmm_plain(gs, x, precision=precision))
    if case == "hub_items":
        assert len(gs.segments) > 1
        # the hub stripe (stripe 0 of the first segment) took several items
        (_, item_stripe), = gs.segments[0].schedules.values()
        assert int((item_stripe == 0).sum()) >= 3


def _hub_row(n, m, seed):
    """Block row 0 holds every column block (hundreds), block rows 2 and 3
    only their filler block, the rest a sparse sprinkle: enough blocks that
    the kernel's work items hold several blocks each."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, 16, 2 * m), rng.integers(0, n, 3 * m)])
    c = rng.integers(0, m, r.size)
    keep = (r < 256) | (r >= 512)
    a = sp.csr_matrix((rng.random(int(keep.sum())).astype(np.float32) + 0.5,
                       (r[keep], c[keep])), shape=(n, m))
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case,f", [("square", 128), ("rect", 45),
                                    ("hub_row", 45), ("hub_row", 128)])
def test_bsr_kernel_matches_plain(cuda, case, f, precision):
    if case == "square":
        a = _rand(1000, 1000, 30000, 4)
    elif case == "rect":
        a = _rand(700, 1300, 30000, 4)
    else:
        a = _hub_row(700, 70000, 4)
    shape = a.shape
    sm = SparseMatrix.from_scipy(a, backend="bsr", precision=precision,
                                 device=cuda)
    if case == "hub_row":
        counts = torch.diff(sm.bsr.row_ptr)
        assert int(counts[0]) >= 40 and (counts[2:4] == 1).all()
        items = tbsr.work_items(sm.bsr, f, cuda)
        assert int((items[:, 2] - items[:, 1]).max()) > 1
    x = torch.randn(shape[1], f, device=cuda)
    before = tbsr.bsr_spmm.launches
    got = tbsr.bsr_spmm(sm.bsr, x, n_out=shape[0], precision=precision)
    torch.cuda.synchronize()
    assert tbsr.bsr_spmm.launches == before + 1
    _close(got, tbsr.bsr_spmm_plain(sm.bsr, x, n_out=shape[0],
                                    precision=precision))
    if case == "hub_row":
        assert (got[256:512] == 0).all()  # the filler-only rows


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


def _mask(n, B, seed, self_loops=True, empty=False):
    a = _rand(n, n, 4 * n, seed)
    a = ((a + a.T) > 0).astype(np.float32)
    if self_loops:
        a = a + sp.eye(n, dtype=np.float32)
    a = (a > 0).astype(np.float32).tolil()
    if empty:  # block row and column 1 hold no entry: filler blocks
        a[B:2 * B, :] = 0
        a[:, B:2 * B] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


# (B, n, H, F, self loops, an empty block row and column); the last three
# take the kernels' wider instantiations (H > 32, H*F = 512)
GAT_CASES = [(256, 2708, 8, 8, True, False), (256, 2708, 1, 7, True, False),
             (128, 600, 3, 7, False, True), (128, 500, 40, 3, True, False),
             (256, 300, 1, 512, True, False), (128, 300, 2, 256, True, True)]


@pytest.mark.parametrize("case", GAT_CASES, ids=str)
def test_gat_kernels_match_plain(cuda, case):
    B, n, H, F, loops, empty = case
    sm = SparseMatrix.from_scipy(_mask(n, B, 7, loops, empty), backend="bsr",
                                 block_size=B, device=cuda)
    bsr = sm.bsr
    n_pad = bsr.n_row_blocks * B
    gen = torch.Generator(device=cuda).manual_seed(0)
    f1, f2 = (tatt.pad_rows(torch.randn(n, H, generator=gen, device=cuda),
                            n_pad) for _ in range(2))
    h, g = (tatt.pad_rows(torch.randn(n, H * F, generator=gen, device=cuda),
                          n_pad) for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    launches = (tatt.gat_fwd_stats.launches, tatt.gat_bwd_row.launches,
                tatt.gat_bwd_col.launches)
    out, m, l = tatt.gat_fwd_stats(bsr, f1, f2, h, **kw)
    ref = tatt.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)
    d = tatt.head_dots(g, ref[0], H, F)
    df1 = tatt.gat_bwd_row(bsr, f1, f2, h, g, *ref[1:], d, **kw)
    dh, df2 = tatt.gat_bwd_col(bsr, f1, f2, h, g, *ref[1:], d, **kw)
    torch.cuda.synchronize()
    assert (tatt.gat_fwd_stats.launches, tatt.gat_bwd_row.launches,
            tatt.gat_bwd_col.launches) == tuple(c + 1 for c in launches)
    for got, want in zip((out, m, l), ref):
        _close(got, want, GAT_TOL)
    _close(df1, tatt.gat_bwd_row_plain(bsr, f1, f2, h, g, *ref[1:], d, **kw),
           GAT_TOL)
    for got, want in zip((dh, df2), tatt.gat_bwd_col_plain(
            bsr, f1, f2, h, g, *ref[1:], d, **kw)):
        _close(got, want, GAT_TOL)
    if empty:
        assert (l[B:2 * B] == 0).all() and (out[B:2 * B] == 0).all()
        assert (m[B:2 * B] == tatt.NEG_INF).all()


def test_gat_attention_backward_launches_its_kernels(cuda):
    n, H, F = 1000, 8, 8
    sm = SparseMatrix.from_scipy(_mask(n, 256, 8), backend="bsr",
                                 block_size=256, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(n, w, generator=gen, device=cuda, requires_grad=True)
          for w in (H, H, H * F)]
    gw = torch.randn(n, H * F, generator=gen, device=cuda)
    before = tatt.gat_fwd_stats.launches
    out = tatt.gat_attention(sm.bsr, *xs, num_heads=H, feat=F, n_out=n)
    assert tatt.gat_fwd_stats.launches == before + 1
    rows, cols = tatt.gat_bwd_row.launches, tatt.gat_bwd_col.launches
    (out * gw).sum().backward()
    torch.cuda.synchronize()
    assert tatt.gat_bwd_row.launches == rows + 1
    assert tatt.gat_bwd_col.launches == cols + 1
    # the same on the CPU, through the plain versions
    cpu = SparseMatrix.from_scipy(sm.to_scipy(), backend="bsr",
                                  block_size=256)
    xc = [x.detach().cpu().requires_grad_(True) for x in xs]
    outc = tatt.gat_attention(cpu.bsr, *xc, num_heads=H, feat=F, n_out=n)
    (outc * gw.cpu()).sum().backward()
    _close(out.detach().cpu(), outc.detach(), GAT_TOL)
    for x, c in zip(xs, xc):
        _close(x.grad.cpu(), c.grad, GAT_TOL)


def test_gat_kernels_refuse_what_they_do_not_take(cuda):
    sm = SparseMatrix.from_scipy(_mask(300, 128, 9), backend="bsr",
                                 device=cuda)
    n_pad = sm.bsr.n_row_blocks * 128
    f = torch.zeros(n_pad, 1, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        tatt.gat_fwd_stats(sm.bsr, f, f, torch.zeros(n_pad, 513, device=cuda),
                           num_heads=1, feat=513)
    bf16 = SparseMatrix.from_scipy(_mask(300, 128, 9), backend="bsr",
                                   precision="default", device=cuda)
    with pytest.raises(ValueError, match="f32 mask"):
        tatt.gat_fwd_stats(bf16.bsr, f, f, torch.zeros(n_pad, 8, device=cuda),
                           num_heads=1, feat=8)


def test_gat_model_fused_matches_segment_on_the_card(cuda):
    n, d, c = 2708, 64, 7
    support = _mask(n, 256, 10)
    x = torch.rand(n, d, device=cuda)
    model = tgat.GATNetwork(c, fused_attention=True, attn_drop=0.0)
    model.init(d, 1, torch.Generator().manual_seed(0), cuda)
    adj = tgat.build_gat_adjacency(support, True, device=cuda)
    before = tatt.gat_fwd_stats.launches
    fused = model(adj, x, [], training=False)
    assert tatt.gat_fwd_stats.launches == before + 2
    model.fused_attention = False
    seg = model(adj, x, [], training=False)
    _close(fused.detach(), seg.detach(), GAT_TOL)


def _hub_mask(n, hubs, seed):
    """A symmetric self-looped mask whose first ``hubs`` nodes link to every
    node: one tile holds more slots than shared memory (the workspace
    path), and each hub row and column has n edges."""
    a = _mask(n, 128, seed).tolil()
    a[:hubs, :] = 1
    a[:, :hubs] = 1
    return a.tocsr()


# (T, n, H, F, self loops, an empty tile row and column, hub nodes,
# segment size); the wide cases take the kernels' other instantiations
COO_CASES = [(256, 2708, 8, 8, True, False, 0, None),
             (256, 2708, 1, 7, True, False, 0, None),
             (128, 600, 3, 7, False, True, 0, 16),
             (128, 500, 40, 3, True, False, 0, None),
             (256, 300, 1, 512, True, False, 0, None),
             (128, 300, 2, 256, True, True, 0, 8),
             (256, 3000, 8, 8, True, False, 24, None)]


def _coo_inputs(case, cuda):
    T, n, H, F, loops, empty, hubs, max_chunks = case
    a = _hub_mask(n, hubs, 7) if hubs else _mask(n, T, 7, loops, empty)
    ac = tcoo.build_attn_coo(a, tile=T, max_chunks=max_chunks, device=cuda)
    n_pad = ac.n_tiles * T
    gen = torch.Generator(device=cuda).manual_seed(0)
    f1, f2 = (tatt.pad_rows(torch.randn(n, H, generator=gen, device=cuda),
                            n_pad) for _ in range(2))
    h, g = (tatt.pad_rows(torch.randn(n, H * F, generator=gen, device=cuda),
                          n_pad) for _ in range(2))
    return ac, f1, f2, h, g


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", COO_CASES, ids=str)
def test_coo_kernels_match_plain(cuda, case, precision):
    T, n, H, F, loops, empty, hubs, max_chunks = case
    ac, f1, f2, h, g = _coo_inputs(case, cuda)
    if hubs:  # the fullest tile's list does not fit in shared memory
        assert ac.fwd[0].max_tile_slots * 4 > tcoo._SMEM_BYTES
    kw = dict(num_heads=H, feat=F, precision=precision)
    tol = GAT_TOL if precision == "highest" else BF16_TOL
    launches = (tcoo.coo_fwd_stats.launches, tcoo.coo_bwd_row.launches,
                tcoo.coo_bwd_col.launches)
    out, m, l = tcoo.coo_fwd_stats(ac, f1, f2, h, **kw)
    ref = tcoo.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
    d = tatt.head_dots(g, ref[0], H, F)
    df1 = tcoo.coo_bwd_row(ac, f1, f2, h, g, *ref[1:], d, **kw)
    dh, df2 = tcoo.coo_bwd_col(ac, f1, f2, h, g, *ref[1:], d, **kw)
    torch.cuda.synchronize()
    # the row pass launches once a segment; the forward and the column
    # pass once a call over the per-row and per-column lists
    assert (tcoo.coo_fwd_stats.launches, tcoo.coo_bwd_row.launches,
            tcoo.coo_bwd_col.launches) == (
                launches[0] + 1, launches[1] + len(ac.fwd), launches[2] + 1)
    if max_chunks:
        assert len(ac.fwd) > 1 and len(ac.bwd) > 1
    _close(out, ref[0], tol)
    for got, want in zip((m, l), ref[1:]):  # f32 statistics either way
        _close(got, want, GAT_TOL)
    _close(df1, tcoo.coo_bwd_row_plain(ac, f1, f2, h, g, *ref[1:], d, **kw),
           tol)
    for got, want in zip((dh, df2), tcoo.coo_bwd_col_plain(
            ac, f1, f2, h, g, *ref[1:], d, **kw)):
        _close(got, want, tol)
    if empty:  # rows without an edge keep the sentinel state exactly
        assert (l[T:2 * T] == 0).all() and (out[T:2 * T] == 0).all()
        assert (m[T:2 * T] == tatt.NEG_INF).all()
        assert (dh[T:2 * T] == 0).all() and (df2[T:2 * T] == 0).all()


def test_coo_default_precision_is_near_f32(cuda):
    case = COO_CASES[0]
    ac, f1, f2, h, _ = _coo_inputs(case, cuda)
    kw = dict(num_heads=case[2], feat=case[3])
    out = tcoo.coo_fwd_stats(ac, f1, f2, h, precision="default", **kw)[0]
    ref = tcoo.coo_fwd_stats_plain(ac, f1, f2, h, **kw)[0]
    _close(out, ref, BF16_TOL)


def test_gat_attention_coo_backward_launches_its_kernels(cuda):
    n, H, F = 1000, 8, 8
    a = _mask(n, 256, 8)
    ac = tcoo.build_attn_coo(a, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(n, w, generator=gen, device=cuda, requires_grad=True)
          for w in (H, H, H * F)]
    gw = torch.randn(n, H * F, generator=gen, device=cuda)
    before = tcoo.coo_fwd_stats.launches
    out = tcoo.gat_attention_coo(ac, *xs, num_heads=H, feat=F, n_out=n)
    assert tcoo.coo_fwd_stats.launches == before + 1
    rows, cols = tcoo.coo_bwd_row.launches, tcoo.coo_bwd_col.launches
    (out * gw).sum().backward()
    torch.cuda.synchronize()
    assert tcoo.coo_bwd_row.launches == rows + 1
    assert tcoo.coo_bwd_col.launches == cols + 1
    # the same on the CPU, through the plain versions
    cpu = tcoo.build_attn_coo(a)
    xc = [x.detach().cpu().requires_grad_(True) for x in xs]
    outc = tcoo.gat_attention_coo(cpu, *xc, num_heads=H, feat=F, n_out=n)
    (outc * gw.cpu()).sum().backward()
    _close(out.detach().cpu(), outc.detach(), GAT_TOL)
    for x, c in zip(xs, xc):
        _close(x.grad.cpu(), c.grad, GAT_TOL)


def _star_support(n, hub_edges, seed):
    """A self-looped support whose node 0 links to ``hub_edges`` nodes both
    ways (a row and a column cut into many pieces), over a sparse random
    rest, with rows and columns 40-79 left without an edge."""
    rng = np.random.default_rng(seed)
    nb = rng.choice(np.arange(80, n), hub_edges, replace=False)
    r = np.concatenate([np.zeros(hub_edges, np.int64), nb])
    c = np.concatenate([nb, np.zeros(hub_edges, np.int64)])
    star = sp.csr_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))
    a = (_rand(n, n, 4 * n, seed) + star
         + sp.eye(n, dtype=np.float32)).tolil()
    a[40:80, :] = 0
    a[:, 40:80] = 0
    a = (a.tocsr() > 0).astype(np.float32)
    a.eliminate_zeros()
    return a.tocsr()


# (graph, n, tile, H, F, budget, warps): a star row of >= 5,000 edges; rows
# without an edge; n not a multiple of the tile; layer 2 (1 head of 7) and
# the limit H * F = 512; the 10K graph's skew at a reduced n; other budgets
# and warps a block
COO_ITEM_CASES = [("star", 9000, 256, 8, 8, None, None),
                  ("star", 9000, 256, 1, 7, None, None),
                  ("star", 9000, 256, 8, 64, 32, 4),
                  ("star", 6100, 128, 3, 5, 256, 16),
                  ("skewed", 4000, 256, 8, 8, 64, None),
                  ("skewed", 4000, 256, 1, 7, 32, 16),
                  ("skewed", 4000, 256, 16, 32, 64, 8),
                  ("skewed", 3001, 256, 2, 1, 16, 2)]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", COO_ITEM_CASES, ids=str)
def test_coo_work_items_match_plain(cuda, case, precision):
    """The forward and the column pass over their work items, hub rows
    split and merged, against the plain versions; the row pass beside them
    on the same payload."""
    graph, n, T, H, F, budget, warps = case
    a = (_star_support(n, 5200, 21) if graph == "star"
         else _skewed_support(n, 22))
    ac = tcoo.build_attn_coo(a, tile=T, device=cuda)
    n_pad = ac.n_tiles * T
    assert n % T or graph == "star"
    items = {kind: tcoo.edge_items(ac, kind, budget) for kind in ("fwd",
                                                                  "col")}
    for it in items.values():
        assert it.n_split > 0
        if graph == "star":
            assert it.n_pieces - it.n_split >= 5000 // it.budget
    gen = torch.Generator(device=cuda).manual_seed(3)
    f1, f2 = (tatt.pad_rows(torch.randn(n, H, generator=gen, device=cuda),
                            n_pad) for _ in range(2))
    h, g = (tatt.pad_rows(torch.randn(n, H * F, generator=gen, device=cuda),
                          n_pad) for _ in range(2))
    kw = dict(num_heads=H, feat=F, precision=precision)
    tol = GAT_TOL if precision == "highest" else BF16_TOL
    launches = (tcoo.coo_fwd_stats.launches, tcoo.coo_bwd_col.launches)
    out, m, l = tcoo.coo_fwd_stats(ac, f1, f2, h, items=items["fwd"],
                                   warps=warps, **kw)
    ref = tcoo.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
    d = tatt.head_dots(g, ref[0], H, F)
    bwd = (ac, f1, f2, h, g, *ref[1:], d)
    dh, df2 = tcoo.coo_bwd_col(*bwd, items=items["col"], warps=warps, **kw)
    df1 = tcoo.coo_bwd_row(*bwd, **kw)
    torch.cuda.synchronize()
    assert (tcoo.coo_fwd_stats.launches, tcoo.coo_bwd_col.launches) == (
        launches[0] + 1, launches[1] + 1)
    _close(out, ref[0], tol)
    for got, want in zip((m, l), ref[1:]):  # f32 statistics either way
        _close(got, want, GAT_TOL)
    for got, want in zip((dh, df2), tcoo.coo_bwd_col_plain(*bwd, **kw)):
        _close(got, want, tol)
    _close(df1, tcoo.coo_bwd_row_plain(*bwd, **kw), tol)
    # rows without an edge (and the padding rows) keep the sentinel state
    empty = torch.ones(n_pad, dtype=torch.bool, device=cuda)
    empty[:n] = torch.from_numpy(np.diff(a.indptr) == 0).to(cuda)
    assert empty[n:].all() and (graph != "star" or empty[40:80].all())
    assert (m[empty] == tatt.NEG_INF).all() and (l[empty] == 0).all()
    assert (out[empty] == 0).all()
    no_src = torch.ones(n_pad, dtype=torch.bool, device=cuda)
    no_src[:n] = torch.from_numpy(np.diff(a.tocsc().indptr) == 0).to(cuda)
    assert (dh[no_src] == 0).all() and (df2[no_src] == 0).all()


def test_coo_work_items_refuse_what_the_kernels_do_not_take(cuda):
    a = _mask(300, 128, 9)
    ac = tcoo.build_attn_coo(a, tile=128, device=cuda)
    n_pad = ac.n_tiles * 128
    f = torch.zeros(n_pad, 2, device=cuda)
    h = torch.zeros(n_pad, 16, device=cuda)
    with pytest.raises(ValueError, match="warps"):
        tcoo.coo_fwd_stats(ac, f, f, h, num_heads=2, feat=8, warps=17)
    with pytest.raises(ValueError, match="warps"):
        tcoo.coo_bwd_col(ac, f, f, h, h, f, f, f, num_heads=2, feat=8,
                         warps=0)
    with pytest.raises(ValueError, match="'col' work items"):
        tcoo.coo_bwd_col(ac, f, f, h, h, f, f, f, num_heads=2, feat=8,
                         items=tcoo.edge_items(ac, "fwd"))


# (n, m, H, fw, augmented, hub rows); m != n is a rectangular support
WEIGHTED_CASES = [(2708, 2708, 8, 9, True, 0), (2708, 2708, 8, 8, False, 0),
                  (900, 1300, 1, 8, True, 0), (700, 700, 1, 512, False, 0),
                  (600, 600, 8, 65, True, 0), (3000, 3000, 8, 9, True, 24)]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", WEIGHTED_CASES, ids=str)
def test_gscatter_weighted_matches_plain(cuda, case, precision):
    n, m, H, fw, aug, hubs = case
    a = _hub_mask(n, hubs, 11) if hubs else _rand(n, m, 6 * n, 11)
    ga = tgat_.build_gatherattn(a, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    E = ga.num_edges
    wf = torch.rand(E, H, generator=gen, device=cuda)
    wf[torch.rand(E, H, generator=gen, device=cuda) < 0.3] = 0  # dropout
    wl = torch.rand(E, H, generator=gen, device=cuda) if aug else None
    kw = dict(num_heads=H, wl=wl, precision=precision)
    for gs, s2e, items, x_rows in (
            (ga.fwd, ga.slot2edge_fwd, ga.items_fwd, ga.num_src),
            (ga.bwd, ga.slot2edge_bwd, ga.items_bwd, n)):
        x = torch.randn(x_rows, H * fw, generator=gen, device=cuda)
        before = tgat_.gscatter_weighted.launches
        got = tgat_.gscatter_weighted(gs, s2e, wf, x, items=items, **kw)
        torch.cuda.synchronize()
        assert tgat_.gscatter_weighted.launches == before + len(gs.segments)
        _close(got, tgat_.gscatter_weighted_plain(gs, s2e, wf, x, **kw),
               GAT_TOL)


@pytest.mark.parametrize("drop", [False, True])
def test_gather_attention_matches_cpu(cuda, drop):
    n, H, F = 2708, 8, 8
    a = _mask(n, 256, 12)
    ga = tgat_.build_gatherattn(a, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn(n, w, generator=gen, device=cuda, requires_grad=True)
          for w in (H, H, H * F)]
    gw = torch.randn(n, H * F, generator=gen, device=cuda)
    m = None
    if drop:
        m = torch.where(torch.rand(ga.num_edges, H, generator=gen,
                                   device=cuda) < 0.4, 2.5, 0.0)
    before = tgat_.gscatter_weighted.launches
    out = tgat_.gather_attention(ga, *xs, m, num_heads=H, feat=F)
    (out * gw).sum().backward()
    torch.cuda.synchronize()
    assert tgat_.gscatter_weighted.launches == before + 4  # fwd, dh, df1, df2
    cpu = tgat_.build_gatherattn(a)
    xc = [x.detach().cpu().requires_grad_(True) for x in xs]
    outc = tgat_.gather_attention(cpu, *xc, None if m is None else m.cpu(),
                                  num_heads=H, feat=F)
    (outc * gw.cpu()).sum().backward()
    _close(out.detach().cpu(), outc.detach(), GAT_TOL)
    for x, c in zip(xs, xc):
        _close(x.grad.cpu(), c.grad, GAT_TOL)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = _mask(300, 128, 9)
    ac = tcoo.build_attn_coo(a, tile=128, device=cuda)
    n_pad = ac.n_tiles * 128
    f = torch.zeros(n_pad, 1, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        tcoo.coo_fwd_stats(ac, f, f, torch.zeros(n_pad, 513, device=cuda),
                           num_heads=1, feat=513)
    with pytest.raises(ValueError, match="float32"):
        tcoo.coo_fwd_stats(ac, f[:10], f, torch.zeros(n_pad, 8, device=cuda),
                           num_heads=1, feat=8)
    ga = tgat_.build_gatherattn(a, device=cuda)
    x = torch.zeros(300, 16, device=cuda)
    with pytest.raises(ValueError, match="wf"):
        tgat_.gscatter_weighted(ga.fwd, ga.slot2edge_fwd,
                                torch.zeros(ga.num_edges, 3, device=cuda), x,
                                num_heads=2, items=ga.items_fwd)
    with pytest.raises(ValueError, match="work items"):
        tgat_.gscatter_weighted(ga.fwd, ga.slot2edge_fwd,
                                torch.zeros(ga.num_edges, 2, device=cuda), x,
                                num_heads=2)


@pytest.mark.parametrize("impl", ["gather", "coo"])
def test_gat_model_at_scale_payloads_match_segment_on_the_card(cuda, impl):
    n, d, c = 2708, 64, 7
    support = _mask(n, 256, 10)
    x = torch.rand(n, d, device=cuda)
    model = tgat.GATNetwork(c, fused_attention=True, attn_drop=0.0)
    model.init(d, 1, torch.Generator().manual_seed(0), cuda)
    adj = tgat.build_gat_adjacency(support, True, attn_impl=impl, device=cuda)
    assert adj.backend == "attn"
    counter = (tgat_.gscatter_weighted if impl == "gather"
               else tcoo.coo_fwd_stats)
    before = counter.launches
    fused = model(adj, x, [], training=False)
    assert counter.launches == before + 2
    model.fused_attention = False
    seg = model(adj, x, [], training=False)
    _close(fused.detach(), seg.detach(), GAT_TOL)


# (n, m, nnz, F, tile, e_b, rows): a hub tile row whose chunks span many
# thread blocks; F = 7, 64 and 128; an empty band of tile rows; n and m not
# multiples of the tile; a hyper-sparse matrix with e_b chosen from it
COOTILE_CASES = [
    ("hub", 2000, 2000, 200_000, 64, 256, 128, (0, 256)),
    ("f7", 3000, 3000, 40_000, 7, 512, 128, None),
    ("f128", 3000, 3000, 40_000, 128, 512, 256, None),
    ("empty_band", 2600, 2600, 30_000, 64, 256, 64, (0, 700)),
    ("ragged", 1300, 900, 20_000, 45, 512, 128, None),
    ("sparse_auto_eb", 5000, 5000, 6_000, 64, 512, None, None),
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", COOTILE_CASES, ids=lambda c: c[0])
def test_cootile_kernel_matches_plain(cuda, case, precision):
    _, n, m, nnz, f, tile, e_b, rows = case
    a = _rand(n, m, nnz, 11, rows=rows)
    ct = tct.build_cootile(a, tile=tile, e_b=e_b, device=cuda)
    if case[0] == "hub":
        _, per_block, _, _ = tct.work_shape(ct, f, cuda)
        assert ct.heaviest_row_chunks() > 8 * per_block
    x = torch.randn(m, f, device=cuda)
    before = tct.cootile_spmm.launches
    got = tct.cootile_spmm(ct, x, precision=precision)
    torch.cuda.synchronize()
    assert tct.cootile_spmm.launches == before + 1
    _close(got, tct.cootile_spmm_plain(ct, x, precision=precision))
    # the plain version is the matrix's own product (f32 in "highest")
    if precision == "highest":
        dense = torch.from_numpy(a.toarray()).to(cuda)
        _close(got, dense @ x)


def test_cootile_spmm_backward_reads_transpose_payload(cuda):
    a = _rand(900, 1300, 12000, 5)  # not square
    sm = SparseMatrix.from_scipy(a, backend="cootile", device=cuda)
    assert sm.coot_t is not None
    ref = SparseMatrix.from_scipy(a, backend="segment", device=cuda)
    x = torch.randn(1300, 64, device=cuda, requires_grad=True)
    xr = x.detach().clone().requires_grad_(True)
    g = torch.randn(900, 64, device=cuda)
    y = spmm(sm, x)
    before = tct.cootile_spmm.launches
    y.backward(g)
    torch.cuda.synchronize()
    assert tct.cootile_spmm.launches == before + 1
    spmm(ref, xr).backward(g)
    _close(y.detach(), spmm(ref, xr.detach()))
    _close(x.grad, xr.grad)
    no_t = dataclasses.replace(sm, coot_t=None)
    with pytest.raises(RuntimeError, match="no payload"):
        spmm(no_t, x).backward(g)


def test_cootile_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = _rand(500, 500, 3000, 6)
    ct = tct.build_cootile(a, tile=2048, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        tct.cootile_spmm(ct, torch.randn(500, 8, device=cuda))
    ct = tct.build_cootile(a, tile=256, device=cuda)
    with pytest.raises(ValueError, match="does not match"):
        tct.cootile_spmm(ct, torch.randn(400, 8, device=cuda))
    ct_cpu = tct.build_cootile(a, tile=256)
    with pytest.raises(ValueError, match="tables"):
        tct.cootile_spmm(ct_cpu, torch.randn(500, 8, device=cuda))


def _shuffle_chunks(ct, seed):
    """``ct`` with each chunk's slots in a random order (rows, cols and
    vals moved together): the same matrix, its row runs cut up."""
    g = torch.Generator(device=ct.rows.device).manual_seed(seed)
    perm = torch.argsort(torch.rand(tuple(ct.rows.shape), generator=g,
                                    device=ct.rows.device), dim=1)
    return dataclasses.replace(ct, **{
        k: torch.gather(getattr(ct, k), 1, perm).contiguous()
        for k in ("rows", "cols", "vals")})


# (name, n, m, nnz, tile, rows): a hub tile row spread over many chunk
# ranges (and its transpose, whose hub is a tile column); a rectangular
# matrix whose slots are shuffled inside their chunks; tile 128 and 256
COOTILE_WIDE_CASES = [("hub", 3000, 3000, 300_000, 256, (0, 256)),
                      ("shuffled", 1500, 2600, 60_000, 128, None)]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("f", [7, 64, 72, 128])
@pytest.mark.parametrize("case", COOTILE_WIDE_CASES, ids=lambda c: c[0])
def test_cootile_full_width_matches_plain(cuda, case, f, precision):
    """All F in one thread block and row runs summed in registers: forward
    and backward (the transpose tables) against the plain version at every
    width the models and the odd widths take, in any slot order."""
    name, n, m, nnz, tile, rows = case
    a = _rand(n, m, nnz, 13, rows=rows)
    sm = SparseMatrix.from_scipy(a, backend="cootile", precision=precision,
                                 device=cuda)
    sm = dataclasses.replace(
        sm, coot=tct.build_cootile(a, tile=tile, device=cuda),
        coot_t=tct.build_cootile(a.T.tocsr(), tile=tile, device=cuda))
    if name == "shuffled":
        runs = tct.row_runs(sm.coot)
        sm = dataclasses.replace(sm, coot=_shuffle_chunks(sm.coot, 1),
                                 coot_t=_shuffle_chunks(sm.coot_t, 2))
        assert tct.row_runs(sm.coot) > runs
    else:
        w, per_block, _, _ = tct.work_shape(sm.coot, f, cuda)
        assert w >= min(f, 32) and sm.coot.heaviest_row_chunks() > 8 * per_block
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(m, f, generator=gen, device=cuda, requires_grad=True)
    g = torch.randn(n, f, generator=gen, device=cuda)
    before = tct.cootile_spmm.launches
    y = spmm(sm, x)
    y.backward(g)
    torch.cuda.synchronize()
    assert tct.cootile_spmm.launches == before + 2
    _close(y.detach(), tct.cootile_spmm_plain(sm.coot, x.detach(),
                                              precision=precision), 1e-4)
    _close(x.grad, tct.cootile_spmm_plain(sm.coot_t, g, precision=precision),
           1e-4)


@pytest.mark.parametrize("width", [32, 64, 128])
def test_cootile_feature_tiles_agree(cuda, width):
    """Every width the kernel is built for, over one or several feature
    tiles of F = 200: the same sums."""
    a = _rand(2000, 2000, 50_000, 14)
    ct = tct.build_cootile(a, tile=256, device=cuda)
    x = torch.randn(2000, 200, device=cuda)
    got = tct.cootile_spmm(ct, x, width=width)
    torch.cuda.synchronize()
    _close(got, tct.cootile_spmm_plain(ct, x))


def _skewed_support(n, seed):
    """A hub-skewed self-looped support: the 10K graph's shape, smaller."""
    a = _rand(n, n, 3 * n, seed)
    rng = np.random.default_rng(seed)
    hubs = rng.integers(0, n // 16, 4 * n)  # edges into the first stripe
    b = sp.csr_matrix((np.ones(hubs.size, np.float32),
                       (hubs, rng.integers(0, n, hubs.size))), shape=(n, n))
    a = ((a + b + b.T + sp.eye(n, dtype=np.float32)) > 0).astype(np.float32)
    return a.tocsr()


# (H, fw, augmented): layer 1's forward, df1 and df2 (8 heads of 8 + 1)
# and its dh (8 x 8); layer 2 (1 head of 7 + 1)
COMBINE_CASES = [(8, 9, True), (8, 8, False), (1, 8, True)]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("tile,warps", [(512, 32), (128, 16)])
@pytest.mark.parametrize("case", COMBINE_CASES, ids=str)
def test_combine_work_items_match_plain(cuda, case, tile, warps, precision):
    """The combine over work items, the heaviest stripe split: the forward
    and the three backward combines of a step against the plain version."""
    H, fw, aug = case
    n = 6000
    a = _skewed_support(n, 15)
    ga = tgat_.build_gatherattn(a, tile=tile, device=cuda)
    ptr = ga.fwd.segments[0].chunk_ptr.cpu().numpy()
    heavy = int(np.argmax(np.diff(ptr)))
    assert int((ga.items_fwd[0][1].cpu() == heavy).sum()) > 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    E = ga.num_edges
    wf = torch.rand(E, H, generator=gen, device=cuda)
    wf[torch.rand(E, H, generator=gen, device=cuda) < 0.4] = 0  # dropout
    wl = torch.rand(E, H, generator=gen, device=cuda) if aug else None
    kw = dict(num_heads=H, wl=wl, precision=precision)
    # forward / df1 over the forward tables, dh / df2 over the transpose
    for gs, s2e, items in ((ga.fwd, ga.slot2edge_fwd, ga.items_fwd),
                           (ga.bwd, ga.slot2edge_bwd, ga.items_bwd)):
        x = torch.randn(n, H * fw, generator=gen, device=cuda)
        before = tgat_.gscatter_weighted.launches
        got = tgat_.gscatter_weighted(gs, s2e, wf, x, items=items,
                                      warps=warps, **kw)
        torch.cuda.synchronize()
        assert tgat_.gscatter_weighted.launches == before + len(gs.segments)
        _close(got, tgat_.gscatter_weighted_plain(gs, s2e, wf, x, **kw),
               GAT_TOL)


@pytest.mark.parametrize("piece,range_slots", [(1, 16384), (4, 65536),
                                               (8, 4096)])
@pytest.mark.parametrize("e_b", [48, 96, 128])
def test_cootile_schedules_match_plain(cuda, e_b, piece, range_slots):
    """Both of the kernel's schedules (and others) on a hub tile row, with
    chunks whose size is not a multiple of 32, so a 32-slot group spans
    two chunks: the same sums as the plain version."""
    a = _rand(3000, 3000, 150_000, 16, rows=(0, 256)) + _rand(
        3000, 3000, 30_000, 17)
    ct = tct.build_cootile(a.tocsr(), tile=256, e_b=e_b, device=cuda)
    x = torch.randn(3000, 64, device=cuda)
    for precision in ("highest", "default"):
        got = tct.cootile_spmm(ct, x, precision=precision, piece=piece,
                               range_slots=range_slots)
        torch.cuda.synchronize()
        _close(got, tct.cootile_spmm_plain(ct, x, precision=precision))

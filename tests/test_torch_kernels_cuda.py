"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs on a GPU machine without it:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``. Every
test here needs a CUDA GPU and nvcc and skips without them. Tolerance: the
kernels sum in another order than index_add_ / einsum (atomics, tiles), so
the error is held at 1e-5 of the output's scale; bf16 rounding is the same
on both sides. The GAT attention kernels also rescale their online softmax
batch by batch where the plain versions take each row's max at once, so they
are held at 1e-4 of the output's scale, the gate of chip_smoke.py; so is the
weighted gather-scatter combine of the gather attention, whose weights come
from the softmax. The COO-chunk kernels in "default" precision round their
contraction operands to bf16 at the running row max where the plain
version rounds at the final one, so they are held at 3e-2 of the output's
scale, the JAX package's bound for its bf16 mode. The COO-tile SpMM rounds
where its plain version rounds in both precisions and is held at 1e-5. The
main path's hop matrices at full size (the 10K graph's Â₂ and the 250K
graph's), whose rows sum thousands of entries, are held at 1e-4 in both
precisions."""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch import tracing
from h2gcn_tpu_torch.models import GAT as tgat
from h2gcn_tpu_torch.sparse import SparseMatrix, spmm
from h2gcn_tpu_torch.sparse import attention as tatt
from h2gcn_tpu_torch.sparse import attention_coo as tcoo
from h2gcn_tpu_torch.sparse import attention_gather as tgat_
from h2gcn_tpu_torch.sparse import bsr_spmm as tbsr
from h2gcn_tpu_torch.sparse import cootile as tct
from h2gcn_tpu_torch.sparse import gscatter as tgs
from h2gcn_tpu_torch.sparse import matrix as tmx

TOL = 1e-5
GAT_TOL = 1e-4
BF16_TOL = 3e-2
# the main path's matrices at full size: rows of thousands of entries
SCALE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches(*wrappers):
    return tuple(tracing.counter("launches." + w) for w in wrappers)


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


@functools.cache
def _main_path_matrix(name):
    """A hop matrix of the main path at full size, built as the CLI builds
    it: ``a2_10k``, the symmetric-normalised Â₂ of bench.py's 10K-node
    graph; ``a2c_250k``, the 250K-node graph's Â₂ (24,999,792 entries) in
    the cluster order of ``--reorder cluster``."""
    import chip_smoke
    from h2gcn_tpu_torch.sparse import transforms as tt

    if name == "a2_10k":
        return tt.normalize(tt.nhood_split(chip_smoke.build_graph(), 2)[2]
                            ).tocsr()
    split = tt.nhood_split(chip_smoke.scale_graph(), 2)
    a1, a2 = (tt.normalize(split[k]).tocsr() for k in (1, 2))
    return tt.permute_graph(a2, tt.cluster_order(abs(a1) + abs(a2)))


def _row_major(a, device, budget=None):
    return tgs.build_row_major(
        a.indptr, torch.from_numpy(a.indices.astype(np.int32)).to(device),
        torch.from_numpy(a.data).to(device), a.shape[1], budget=budget)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", ["plain", "segments", "megahub", "ragged",
                                  "hub_items", "wide", "a2_10k"])
def test_gscatter_kernel_matches_plain(cuda, case, precision):
    budget, tol = None, TOL
    if case == "a2_10k":
        # the main path's Â₂ at its width, forward and transpose
        a, f, tol = _main_path_matrix(case), 128, SCALE_TOL
    elif case == "plain":
        a, f = _rand(3000, 3000, 40000, 0), 128
    elif case == "segments":
        # many small items, their cuts moved to row ends: no row split
        a, f, budget = _rand(5000, 4000, 60000, 1), 64, 40
    elif case == "megahub":
        # 512 rows of about 39 entries, each longer than the budget
        a, f, budget = _rand(2000, 2000, 20000, 2, rows=(1024, 1536)), 64, 16
    elif case == "ragged":
        # F not a multiple of 4, empty rows up to the last, n not a multiple
        # of the groups a block
        a, f, budget = _rand(1300, 900, 5000, 3, rows=(0, 400)), 45, 50
    elif case == "hub_items":
        # one row of about 77,000 entries (many items) beside light rows
        a = (_rand(3000, 100_000, 80000, 8, rows=(0, 1))
             + _rand(3000, 100_000, 20000, 9)).tocsr()
        f = 128
    else:
        # wider than one feature tile, rows longer than the budget
        a, f, budget = _rand(1000, 1200, 30000, 10), 200, 8
    if case == "a2_10k":
        sm = SparseMatrix.from_scipy(a, backend="gscatter",
                                     precision=precision, device=cuda)
        rm = sm.gsc
    else:
        rm = _row_major(a, cuda, budget)
    if case in ("megahub", "hub_items", "wide"):
        assert rm.n_split > 0
    if case == "hub_items":
        # the hub row took many items, one piece each
        assert int(rm.splits[1, 0] - rm.splits[0, 0]) >= 50
    if case == "segments":
        assert rm.n_split == 0 and rm.n_items > 1000
    x = torch.randn(a.shape[1], f, device=cuda)
    # the output's memory held NaN before: a row the kernel skips shows
    torch.full((a.shape[0], f), float("nan"), device=cuda)
    before = tracing.counter("launches.gscatter_spmm")
    got = tgs.gscatter_spmm(rm, x, precision=precision)
    torch.cuda.synchronize()
    assert tracing.counter("launches.gscatter_spmm") - before == 1
    _close(got, tgs.gscatter_rows_plain(rm, x, precision=precision), tol)
    if case == "ragged":
        assert (got[400:] == 0).all()
    # the split rows' counters are left zero, and the sums deterministic
    for counters in rm.counters.values():
        assert not counters.any()
    assert torch.equal(got, tgs.gscatter_spmm(rm, x, precision=precision))
    if case == "a2_10k":
        xr = x.clone().requires_grad_(True)
        g = torch.randn(a.shape[0], f, device=cuda)
        spmm(sm, xr).backward(g)
        _close(xr.grad, tgs.gscatter_rows_plain(
            sm.transpose_view().gsc, g, precision=precision), tol)


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
                                    ("hub_row", 45), ("hub_row", 128),
                                    ("a2_10k", 128)])
def test_bsr_kernel_matches_plain(cuda, case, f, precision):
    tol = TOL
    if case == "a2_10k":
        # the main path's Â₂ at its width, forward and transpose
        a, tol = _main_path_matrix(case), SCALE_TOL
    elif case == "square":
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
    before = tracing.counter("launches.bsr_spmm")
    got = tbsr.bsr_spmm(sm.bsr, x, n_out=shape[0], precision=precision)
    torch.cuda.synchronize()
    assert tracing.counter("launches.bsr_spmm") == before + 1
    _close(got, tbsr.bsr_spmm_plain(sm.bsr, x, n_out=shape[0],
                                    precision=precision), tol)
    if case == "hub_row":
        assert (got[256:512] == 0).all()  # the filler-only rows
    if case == "a2_10k":
        xr = x.clone().requires_grad_(True)
        g = torch.randn(shape[0], f, device=cuda)
        spmm(sm, xr).backward(g)
        _close(xr.grad, tbsr.bsr_spmm_plain(
            sm.transpose_view().bsr, g, n_out=shape[1], precision=precision),
            tol)


@pytest.mark.parametrize("backend", ["gscatter", "bsr"])
def test_spmm_backward_reads_transpose_payload(cuda, backend):
    a = _rand(900, 900, 12000, 5)  # not symmetric
    sm = SparseMatrix.from_scipy(a, backend=backend, device=cuda)
    ref = SparseMatrix.from_scipy(a, backend="segment", device=cuda)
    x = torch.randn(900, 64, device=cuda, requires_grad=True)
    xr = x.detach().clone().requires_grad_(True)
    g = torch.randn(900, 64, device=cuda)
    counter = ("launches.gscatter_spmm" if backend == "gscatter"
               else "launches.bsr_spmm")
    y = spmm(sm, x)
    before = tracing.counter(counter)
    y.backward(g)
    torch.cuda.synchronize()
    assert tracing.counter(counter) > before  # the backward ran the kernel
    spmm(ref, xr).backward(g)
    _close(x.grad, xr.grad)


@pytest.mark.parametrize("symmetric", [True, False])
def test_auto_routes_dense_blocks_to_bsr(cuda, symmetric):
    """A matrix whose 128-blocks are near full (squirrel's Â₂) gets ``auto``'s
    BSR route, and the BSR payload alone: no gscatter tables. Its forward
    and backward (the transpose payload where it is not symmetric) match
    the plain version."""
    a = _rand(1000, 1000, 400_000, 9)
    if symmetric:
        a = (a + a.T).tocsr()
    assert a.nnz >= 2 * tmx.BSR_MIN_ENTRIES_PER_BLOCK["highest"] * 8 * 8
    before = tracing.counter("route.bsr")
    sm = SparseMatrix.from_scipy(a, backend="auto", device=cuda)
    assert tracing.counter("route.bsr") == before + 1
    assert sm.backend == "bsr" and sm.symmetric == symmetric
    assert sm.gsc is None and sm.gsc_t is None and sm.coot is None
    assert (sm.bsr_t is None) == symmetric
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(1000, 128, generator=gen, device=cuda,
                    requires_grad=True)
    g = torch.randn(1000, 128, generator=gen, device=cuda)
    launches = tracing.counter("launches.bsr_spmm")
    y = spmm(sm, x)
    y.backward(g)
    torch.cuda.synchronize()
    assert tracing.counter("launches.bsr_spmm") == launches + 2
    _close(y.detach(), tbsr.bsr_spmm_plain(sm.bsr, x.detach(), n_out=1000))
    _close(x.grad, tbsr.bsr_spmm_plain(sm.transpose_view().bsr, g,
                                       n_out=1000))


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
    rm = _row_major(a, cuda)
    with pytest.raises(ValueError, match="does not match"):
        tgs.gscatter_spmm(rm, torch.randn(400, 8, device=cuda))
    with pytest.raises(ValueError, match="payload is on"):
        tgs.gscatter_spmm(_row_major(a, "cpu"),
                          torch.randn(500, 8, device=cuda))
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
    launches = _launches("gat_fwd_stats", "gat_bwd_row", "gat_bwd_col")
    out, m, l = tatt.gat_fwd_stats(bsr, f1, f2, h, **kw)
    ref = tatt.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)
    d = tatt.head_dots(g, ref[0], H, F)
    df1 = tatt.gat_bwd_row(bsr, f1, f2, h, g, *ref[1:], d, **kw)
    dh, df2 = tatt.gat_bwd_col(bsr, f1, f2, h, g, *ref[1:], d, **kw)
    torch.cuda.synchronize()
    assert _launches("gat_fwd_stats", "gat_bwd_row", "gat_bwd_col") == tuple(
        c + 1 for c in launches)
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
    before = tracing.counter("launches.gat_fwd_stats")
    out = tatt.gat_attention(sm.bsr, *xs, num_heads=H, feat=F, n_out=n)
    assert tracing.counter("launches.gat_fwd_stats") == before + 1
    rows, cols = _launches("gat_bwd_row", "gat_bwd_col")
    (out * gw).sum().backward()
    torch.cuda.synchronize()
    assert tracing.counter("launches.gat_bwd_row") == rows + 1
    assert tracing.counter("launches.gat_bwd_col") == cols + 1
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
    before = tracing.counter("launches.gat_fwd_stats")
    fused = model(adj, x, [], training=False)
    assert tracing.counter("launches.gat_fwd_stats") == before + 2
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
    if hubs:  # the hub rows are cut into pieces that a merge launch sums
        assert tcoo.edge_items(ac, "fwd").n_split > 0
    kw = dict(num_heads=H, feat=F, precision=precision)
    tol = GAT_TOL if precision == "highest" else BF16_TOL
    launches = _launches("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col")
    out, m, l = tcoo.coo_fwd_stats(ac, f1, f2, h, **kw)
    ref = tcoo.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
    d = tatt.head_dots(g, ref[0], H, F)
    df1 = tcoo.coo_bwd_row(ac, f1, f2, h, g, *ref[1:], d, **kw)
    dh, df2 = tcoo.coo_bwd_col(ac, f1, f2, h, g, *ref[1:], d, **kw)
    torch.cuda.synchronize()
    # each launches once a call over the per-row and per-column lists,
    # however many segments the tables hold
    assert _launches("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col") == tuple(
        c + 1 for c in launches)
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
        assert (df1[T:2 * T] == 0).all()


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
    before = tracing.counter("launches.coo_fwd_stats")
    out = tcoo.gat_attention_coo(ac, *xs, num_heads=H, feat=F, n_out=n)
    assert tracing.counter("launches.coo_fwd_stats") == before + 1
    rows, cols = _launches("coo_bwd_row", "coo_bwd_col")
    (out * gw).sum().backward()
    torch.cuda.synchronize()
    assert tracing.counter("launches.coo_bwd_row") == rows + 1
    assert tracing.counter("launches.coo_bwd_col") == cols + 1
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
    """The forward, the row pass (over the forward's items) and the column
    pass over their work items, hub rows split and merged, against the
    plain versions."""
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
    launches = _launches("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col")
    out, m, l = tcoo.coo_fwd_stats(ac, f1, f2, h, items=items["fwd"],
                                   warps=warps, **kw)
    ref = tcoo.coo_fwd_stats_plain(ac, f1, f2, h, **kw)
    d = tatt.head_dots(g, ref[0], H, F)
    bwd = (ac, f1, f2, h, g, *ref[1:], d)
    dh, df2 = tcoo.coo_bwd_col(*bwd, items=items["col"], warps=warps, **kw)
    df1 = tcoo.coo_bwd_row(*bwd, items=items["fwd"], warps=warps, **kw)
    torch.cuda.synchronize()
    assert _launches("coo_fwd_stats", "coo_bwd_row", "coo_bwd_col") == tuple(
        c + 1 for c in launches)
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
    assert (out[empty] == 0).all() and (df1[empty] == 0).all()
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


# (B, n, H, F, hub edges): a star hub column cut into pieces beside block
# row and column 1 without an edge; layer 2 (1 head of 7) and the limit
# H * F = 512; several head passes (H = 12)
MASK_COL_CASES = [(256, 2708, 8, 8, 1500), (256, 2708, 1, 7, 1500),
                  (128, 900, 1, 512, 500), (128, 900, 12, 5, 500)]


@pytest.mark.parametrize("case", MASK_COL_CASES, ids=str)
def test_gat_bwd_col_walks_the_masks_column_lists(cuda, case):
    """B5's column pass over per-column lists built from the mask, a hub
    column split and merged, against its plain version; columns without an
    edge get dh = df2 = 0 exactly."""
    B, n, H, F, hub = case
    a = _star_support(n, hub, 31).tolil()
    a[B:2 * B, :] = 0
    a[:, B:2 * B] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    bsr = SparseMatrix.from_scipy(a, backend="bsr", block_size=B,
                                  device=cuda).bsr
    n_pad = bsr.n_row_blocks * B
    it = tatt.mask_col_items(bsr)
    assert it.n_split > 0 and 0 in it.split_rows.tolist()
    ptr, dst = tatt.mask_col_lists(bsr)
    assert int(ptr[-1]) == a.nnz == dst.numel()
    gen = torch.Generator(device=cuda).manual_seed(4)
    f1, f2 = (tatt.pad_rows(torch.randn(n, H, generator=gen, device=cuda),
                            n_pad) for _ in range(2))
    h, g = (tatt.pad_rows(torch.randn(n, H * F, generator=gen, device=cuda),
                          n_pad) for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    out, m, l = tatt.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)
    bwd = (bsr, f1, f2, h, g, m, l, tatt.head_dots(g, out, H, F))
    before = tracing.counter("launches.gat_bwd_col")
    dh, df2 = tatt.gat_bwd_col(*bwd, **kw)
    torch.cuda.synchronize()
    assert tracing.counter("launches.gat_bwd_col") == before + 1
    for got, want in zip((dh, df2), tatt.gat_bwd_col_plain(*bwd, **kw)):
        _close(got, want, GAT_TOL)
    no_src = torch.from_numpy(np.diff(ptr.cpu().numpy()) == 0).to(cuda)
    assert no_src[B:2 * B].all() and no_src[n:].all()
    assert (dh[no_src] == 0).all() and (df2[no_src] == 0).all()


@pytest.mark.parametrize("case", MASK_COL_CASES, ids=str)
def test_gat_fwd_and_row_walk_the_masks_row_lists(cuda, case):
    """B5's forward and row pass over per-row lists built from the mask, a
    hub row split and merged, against their plain versions; rows without
    an edge (block row 1, the padding) keep m = -1e30, l = 0, out = 0 and
    df1 = 0 exactly."""
    B, n, H, F, hub = case
    a = _star_support(n, hub, 33).tolil()
    a[B:2 * B, :] = 0
    a[:, B:2 * B] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    bsr = SparseMatrix.from_scipy(a, backend="bsr", block_size=B,
                                  device=cuda).bsr
    n_pad = bsr.n_row_blocks * B
    it = tatt.mask_row_items(bsr)
    assert it.n_split > 0 and 0 in it.split_rows.tolist()
    ptr, src = tatt.mask_row_lists(bsr)
    assert int(ptr[-1]) == a.nnz == src.numel()
    gen = torch.Generator(device=cuda).manual_seed(6)
    f1, f2 = (tatt.pad_rows(torch.randn(n, H, generator=gen, device=cuda),
                            n_pad) for _ in range(2))
    h, g = (tatt.pad_rows(torch.randn(n, H * F, generator=gen, device=cuda),
                          n_pad) for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    launches = _launches("gat_fwd_stats", "gat_bwd_row")
    got = tatt.gat_fwd_stats(bsr, f1, f2, h, **kw)
    ref = tatt.gat_fwd_stats_plain(bsr, f1, f2, h, **kw)
    bwd = (bsr, f1, f2, h, g, *ref[1:], tatt.head_dots(g, ref[0], H, F))
    df1 = tatt.gat_bwd_row(*bwd, **kw)
    torch.cuda.synchronize()
    assert _launches("gat_fwd_stats", "gat_bwd_row") == tuple(
        c + 1 for c in launches)
    for x, want in zip(got, ref):
        _close(x, want, GAT_TOL)
    _close(df1, tatt.gat_bwd_row_plain(*bwd, **kw), GAT_TOL)
    out, m, l = got
    no_edge = torch.from_numpy(np.diff(ptr.cpu().numpy()) == 0).to(cuda)
    assert no_edge[B:2 * B].all() and no_edge[n:].all()
    assert (m[no_edge] == tatt.NEG_INF).all() and (l[no_edge] == 0).all()
    assert (out[no_edge] == 0).all() and (df1[no_edge] == 0).all()


@pytest.mark.parametrize("kernel", ["coo_bwd_row", "gat_bwd_col",
                                    "gat_bwd_row"])
def test_split_row_passes_repeat_bitwise(cuda, kernel):
    """The merge sums a split row's pieces in piece order, with no atomics:
    two calls on the same inputs give the same bits."""
    n, H, F = 6000, 8, 8
    a = _star_support(n, 5200, 32)
    gen = torch.Generator(device=cuda).manual_seed(5)
    if kernel == "coo_bwd_row":
        pay = tcoo.build_attn_coo(a, device=cuda)
        n_pad = pay.n_tiles * pay.tile
        assert tcoo.edge_items(pay, "fwd").n_split > 0
        fwd, run = tcoo.coo_fwd_stats_plain, tcoo.coo_bwd_row
    else:
        pay = SparseMatrix.from_scipy(a, backend="bsr", block_size=256,
                                      device=cuda).bsr
        n_pad = pay.n_row_blocks * 256
        items = (tatt.mask_col_items if kernel == "gat_bwd_col"
                 else tatt.mask_row_items)
        assert items(pay).n_split > 0
        fwd, run = tatt.gat_fwd_stats_plain, getattr(tatt, kernel)
    f1, f2 = (tatt.pad_rows(torch.randn(n, H, generator=gen, device=cuda),
                            n_pad) for _ in range(2))
    h, g = (tatt.pad_rows(torch.randn(n, H * F, generator=gen, device=cuda),
                          n_pad) for _ in range(2))
    kw = dict(num_heads=H, feat=F)
    out, m, l = fwd(pay, f1, f2, h, **kw)
    bwd = (pay, f1, f2, h, g, m, l, tatt.head_dots(g, out, H, F))
    first = run(*bwd, **kw)
    again = run(*bwd, **kw)
    for x, y in zip(*((r if isinstance(r, tuple) else (r,))
                      for r in (first, again))):
        assert torch.equal(x, y)


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
        before = tracing.counter("launches.gscatter_weighted")
        got = tgat_.gscatter_weighted(gs, s2e, wf, x, items=items, **kw)
        torch.cuda.synchronize()
        assert (tracing.counter("launches.gscatter_weighted")
                == before + len(gs.segments))
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
    before = tracing.counter("launches.gscatter_weighted")
    out = tgat_.gather_attention(ga, *xs, m, num_heads=H, feat=F)
    (out * gw).sum().backward()
    torch.cuda.synchronize()
    # fwd, dh, df1, df2
    assert tracing.counter("launches.gscatter_weighted") == before + 4
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
    counter = ("launches.gscatter_weighted" if impl == "gather"
               else "launches.coo_fwd_stats")
    before = tracing.counter(counter)
    fused = model(adj, x, [], training=False)
    assert tracing.counter(counter) == before + 2
    model.fused_attention = False
    seg = model(adj, x, [], training=False)
    _close(fused.detach(), seg.detach(), GAT_TOL)


# (n, m, nnz, F, tile, e_b, rows): a hub tile row whose chunks span many
# thread blocks; F = 7, 64 and 128; an empty band of tile rows; n and m not
# multiples of the tile; a hyper-sparse matrix with e_b chosen from it; the
# 250K graph's cluster-ordered Â₂ at the main path's widths (nnz None), in
# the default geometry
COOTILE_CASES = [
    ("hub", 2000, 2000, 200_000, 64, 256, 128, (0, 256)),
    ("f7", 3000, 3000, 40_000, 7, 512, 128, None),
    ("f128", 3000, 3000, 40_000, 128, 512, 256, None),
    ("empty_band", 2600, 2600, 30_000, 64, 256, 64, (0, 700)),
    ("ragged", 1300, 900, 20_000, 45, 512, 128, None),
    ("sparse_auto_eb", 5000, 5000, 6_000, 64, 512, None, None),
    ("a2c_250k_f64", 250_000, 250_000, None, 64, None, None, None),
    ("a2c_250k_f128", 250_000, 250_000, None, 128, None, None, None),
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", COOTILE_CASES, ids=lambda c: c[0])
def test_cootile_kernel_matches_plain(cuda, case, precision):
    _, n, m, nnz, f, tile, e_b, rows = case
    if nnz is None:
        a, tol = _main_path_matrix("a2c_250k"), SCALE_TOL
    else:
        a, tol = _rand(n, m, nnz, 11, rows=rows), TOL
    ct = tct.build_cootile(a, tile=tile, e_b=e_b, device=cuda)
    if case[0] == "hub":
        _, per_block, _, _ = tct.work_shape(ct, f, cuda)
        assert ct.heaviest_row_chunks() > 8 * per_block
    x = torch.randn(m, f, device=cuda)
    before = tracing.counter("launches.cootile_spmm")
    got = tct.cootile_spmm(ct, x, precision=precision)
    torch.cuda.synchronize()
    assert tracing.counter("launches.cootile_spmm") == before + 1
    _close(got, tct.cootile_spmm_plain(ct, x, precision=precision), tol)
    # the plain version is the matrix's own product (f32 in "highest"),
    # where the matrix fits the card as a dense one
    if precision == "highest" and nnz is not None:
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
    before = tracing.counter("launches.cootile_spmm")
    y.backward(g)
    torch.cuda.synchronize()
    assert tracing.counter("launches.cootile_spmm") == before + 1
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
    before = tracing.counter("launches.cootile_spmm")
    y = spmm(sm, x)
    y.backward(g)
    torch.cuda.synchronize()
    assert tracing.counter("launches.cootile_spmm") == before + 2
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
        before = tracing.counter("launches.gscatter_weighted")
        got = tgat_.gscatter_weighted(gs, s2e, wf, x, items=items,
                                      warps=warps, **kw)
        torch.cuda.synchronize()
        assert (tracing.counter("launches.gscatter_weighted")
                == before + len(gs.segments))
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


def _baseline_matrices():
    """The baselines' supports on a 3,000-node graph: GCN's self-looped
    sym_norm(A+I) (explicit diagonal), Chebyshev T_3 at eigenvalue 2
    (negative values, much denser than A) with every 7th stored value
    an explicit zero, and GraphSAGE's and bp's row-normalized D^-1 A (not
    symmetric)."""
    from h2gcn_tpu_torch.sparse import transforms as tt

    a = _rand(3000, 3000, 9000, 21)
    a = ((a + a.T) > 0).astype(np.float32).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    cheb = sp.csr_matrix(tt.chebyshev_polynomials(a, 3, eigenvalue=2)[3],
                         dtype=np.float32)
    cheb.data[::7] = 0.0  # stored, not eliminated
    return {"self_looped": tt.normalize(tt.add_eye(a)).tocsr(),
            "cheby_zeros": cheb,
            "rw": tt.normalize(a, tt.NType.RW_NORMALIZED).tocsr()}


def _plain(backend, sm, x):
    if backend == "gscatter":
        return tgs.gscatter_rows_plain(sm.gsc, x)
    if backend == "bsr":
        return tbsr.bsr_spmm_plain(sm.bsr, x, n_out=sm.shape[0])
    return tct.cootile_spmm_plain(sm.coot, x)


_COUNTERS = {"gscatter": "launches.gscatter_spmm",
             "bsr": "launches.bsr_spmm", "cootile": "launches.cootile_spmm"}


@pytest.mark.parametrize("matrix", ["self_looped", "cheby_zeros"])
@pytest.mark.parametrize("f", [7, 16, 1433])
@pytest.mark.parametrize("backend", ["gscatter", "bsr", "cootile"])
def test_spmm_kernels_at_the_baselines_widths(cuda, backend, f, matrix):
    """The widths the baselines aggregate at (bp's and GCN's 7 classes,
    GCN's 16 hidden units, cheby's 1,433 raw features; F = 7 takes BSR's
    scalar loads) on their supports, forward and backward."""
    mat = _baseline_matrices()[matrix]
    if matrix == "cheby_zeros":
        assert (mat.data < 0).any() and (mat.data == 0).any()
    sm = SparseMatrix.from_scipy(mat, backend=backend, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(3000, f, generator=gen, device=cuda, requires_grad=True)
    g = torch.randn(3000, f, generator=gen, device=cuda)
    before = tracing.counter(_COUNTERS[backend])
    y = spmm(sm, x)
    y.backward(g)
    torch.cuda.synchronize()
    assert tracing.counter(_COUNTERS[backend]) >= before + 2
    _close(y.detach(), _plain(backend, sm, x.detach()))
    _close(x.grad, _plain(backend, sm.transpose_view(), g))


@pytest.mark.parametrize("backend", ["gscatter", "bsr", "cootile"])
def test_row_normalized_backward_matches_the_plain_path(cuda, backend):
    """GraphSAGE's D^-1 A is not symmetric: its backward reads the
    transpose payload, held against the segment path's index_add_."""
    mat = _baseline_matrices()["rw"]
    sm = SparseMatrix.from_scipy(mat, backend=backend, device=cuda)
    assert not sm.symmetric
    ref = SparseMatrix.from_scipy(mat, backend="segment", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(3000, 128, generator=gen, device=cuda, requires_grad=True)
    xr = x.detach().clone().requires_grad_(True)
    g = torch.randn(3000, 128, generator=gen, device=cuda)
    before = tracing.counter(_COUNTERS[backend])
    spmm(sm, x).backward(g)
    spmm(ref, xr).backward(g)
    torch.cuda.synchronize()
    assert tracing.counter(_COUNTERS[backend]) >= before + 2
    _close(x.grad, xr.grad)


# ----------------------------------------------- the runtime's entry points
RUN_TOL = 1e-4  # trained runs through the kernels: chip_smoke.py's gate

@pytest.fixture(scope="module")
def small_planetoid(tmp_path_factory):
    import chip_smoke

    path = str(tmp_path_factory.mktemp("planetoid"))
    chip_smoke.write_planetoid(path, "small",
                               chip_smoke.build_graph(n=900, m_edges=3000,
                                                      seed=5),
                               seed=5, n_feat=200, feats_per_row=8,
                               n_test=200)
    return path


def _cli(data_dir, tmp_path, tag, *extra):
    from h2gcn_tpu_torch import run_experiments

    model, *extra = extra
    return run_experiments.main([
        model, "planetoid", "--dataset", "ind.small", "--dataset_path",
        data_dir, "--val_size", "300", "--random_seed", "123",
        "--checkpoint_dir", str(tmp_path / tag), *extra])


def test_blocked_epochs_match_per_epoch_on_the_card(cuda, small_planetoid,
                                                    tmp_path):
    """H2GCN-2 through gscatter: ``--epochs_per_block 4`` against the
    per-epoch run, every epoch's stats and the best state within the
    kernel gate (gscatter's atomics add in a varying order)."""
    import chip_smoke

    common = ("H2GCN", "--sparse_backend", "gscatter", "--epochs", "10",
              "--dropout", "0", "--best_val_criteria", "val_loss")
    runs = []
    for extra in ((), ("--epochs_per_block", "4")):
        with chip_smoke.RecordedEpochs() as rec:
            args = _cli(small_planetoid, tmp_path, str(len(runs)), *common,
                        *extra)
        runs.append((rec.epochs, args))
    (ea, a), (eb, b) = runs
    assert [e for e, _ in ea] == [e for e, _ in eb] == list(range(1, 11))
    for (_, sa), (_, sb) in zip(ea, eb):
        for key, value in sa.items():
            assert abs(sb[key] - value) <= RUN_TOL * max(1.0, abs(value))
    assert (a.objects["best_val_stats"]["epoch"]
            == b.objects["best_val_stats"]["epoch"])
    pa, pb = (r.objects["best_state"]["params"] for r in (a, b))
    for key, ref in pa.items():
        scale = max(1.0, float(ref.abs().max()))
        assert float((pb[key] - ref).abs().max()) <= RUN_TOL * scale, key
    assert [k for k, _ in b.objects["block_times"]] == [4, 4, 2]


def test_attn_step_through_the_gather_payload(cuda, small_planetoid,
                                              tmp_path):
    """The gather payload's coefficients (its call launches the weighted
    combine): each destination's sum to 1, as the segment path's, which
    they match."""
    args = _cli(small_planetoid, tmp_path, "gat", "GAT", "--epochs", "1",
                "--fused_attention", "--attn_impl", "gather")
    tensors, model = args.objects["tensors"], args.objects["model"]
    ga = tensors["adj"].attn
    assert isinstance(ga, tgat_.GatherAttn)
    before = tracing.counter("launches.gscatter_weighted")
    coefs = args.objects["attn_step"](**tensors)
    torch.cuda.synchronize()
    assert tracing.counter("launches.gscatter_weighted") >= before + 2
    model.fused_attention = False
    ref = args.objects["attn_step"](**tensors)
    nnz = tensors["adj"].nnz
    assert torch.equal(tensors["adj"].rows[:nnz].long(), ga.rows)
    for got, want in zip(coefs, ref):
        sums = torch.zeros(ga.n, got.shape[0], device=cuda).index_add_(
            0, ga.rows, got.T)
        assert float((sums - 1).abs().max()) <= GAT_TOL
        _close(got, want[:, :nnz].contiguous(), GAT_TOL)


# ------------------------------------------------- the experiments pipeline
def test_sweep_child_runs_on_the_card(cuda, tmp_path):
    """``run_model`` with the default device spawns a child that trains on
    the card: its ``--timing`` record in the run store counts the routes
    ``auto`` gave its graph's matrices (``route.<backend>``), and the
    launches of each route's kernel."""
    from pathlib import Path

    from h2gcn_tpu_torch.experiments import generation, workflow
    from h2gcn_tpu_torch.modules.runstore import get_project

    conf = {"graphs": [{"method": "mixhop", "numNode": 120, "numClass": 3,
                        "classRatio": [40, 40, 40], "m": 2, "m0": 6,
                        "h": 0.5, "graphName": "mixhop-n120-h0.5-c3"}],
            "features": [{"feature_type": "naive_npz", "var_factor": "all"}],
            "splits": [{"split_config": "0.25p__0.5p", "split_index": 0}]}
    project = generation.run_pipeline(str(tmp_path / "p"), conf,
                                      verbose=False)
    job = next(iter(project))
    cfg = {"model_args": ["H2GCN --network_setup M16-R-T1-G-V-C1-MO "
                          "--adj_nhood 1 2 --hidden 16"]}
    assert workflow.run_model(job, cfg, epochs=3,
                              extra_args=["--timing"])[0][1] == 0
    (split_job, _, _, _, run_id), = workflow.iter_runs(job, cfg)
    ws = Path(split_job.workspace()) / workflow.WORKSPACE_ROOT
    (run,) = get_project(str(ws)).find_jobs({"run_id": run_id})
    assert run.doc["succeeded"]
    timing = run.doc["timing"]
    routes = {k.split(".", 1)[1] for k, v in timing["counters"].items()
              if k.startswith("route.") and v}
    # the adjacency, Â₁ and Â₂ of a 120-node graph: one 128-block each
    assert routes and routes <= {"gscatter", "bsr"}
    for route in routes:
        assert timing["launches"].get(route + "_spmm", 0) > 0, route


def test_precompute_workers_match_one_on_the_card(cuda, small_planetoid,
                                                  tmp_path):
    """``--precompute_workers 2`` (the sharded host split) trains to the
    logits of one worker, within the kernel gate (gscatter's atomics)."""
    logits = []
    for workers in ("1", "2"):
        args = _cli(small_planetoid, tmp_path, workers, "H2GCN",
                    "--epochs", "3", "--precompute_workers", workers)
        with torch.no_grad():
            logits.append(args.objects["predict_step"](
                **args.objects["tensors"]))
    one, two = logits
    assert torch.isfinite(one).all()
    scale = max(1.0, float(one.abs().max()))
    assert float((two - one).abs().max()) <= RUN_TOL * scale


# ---------------------------------------------------------------------------
# The distributed layer's kernels: each shard's local reduces.
# ---------------------------------------------------------------------------


def _sym(n, nnz, seed):
    a = _rand(n, n, nnz, seed)
    a = ((a + a.T) > 0).astype(np.float32)
    deg = np.asarray(a.sum(1)).ravel()
    d = sp.diags(1.0 / np.sqrt(np.maximum(deg, 1)))
    return sp.csr_matrix(d @ a @ d, dtype=np.float32)


def test_halo_cootile_shard_matches_plain(cuda):
    """One shard of a D = 4 halo-cootile partition: its interior and halo
    reduces through B3, forward and Aᵀg, against the plain version."""
    from h2gcn_tpu_torch.parallel import dist as pdist
    from h2gcn_tpu_torch.parallel.mesh import Mesh

    hcm, _ = pdist.shard_matrix_halo_cootile(_sym(4000, 40_000, 21), 4)
    sh = hcm.local(Mesh(rank=1, size=4, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(hcm.n_local, 64, generator=gen, device=cuda)
    recv = torch.randn(4 * hcm.halo, 64, generator=gen, device=cuda)
    g = torch.randn(hcm.n_local, 64, generator=gen, device=cuda)
    for sm, xin in ((sh.interior, x), (sh.halo_mat, recv)):
        assert sm.backend == "cootile" and sm.nnz > 0
        xr = xin.clone().requires_grad_(True)
        before = tracing.counter("launches.cootile_spmm")
        y = spmm(sm, xr)
        y.backward(g)
        torch.cuda.synchronize()
        assert tracing.counter("launches.cootile_spmm") == before + 2
        _close(y.detach(), tct.cootile_spmm_plain(sm.coot, xin))
        t = sm.transpose_view()
        _close(xr.grad, tct.cootile_spmm_plain(t.coot, g))


def test_dist_gat_shard_matches_plain(cuda):
    """One rectangular shard of dest-stripe GAT (D = 4): the attention
    forward through #10 against the CPU's plain version, and the four
    combines of a training step (forward, dh, df1, df2) against the plain
    combine on the card. (The backward's df1 and df2 cancel terms, so
    their end values are held through the combines that feed them.)"""
    from h2gcn_tpu_torch.parallel import attention as pattn
    from h2gcn_tpu_torch.parallel.mesh import Mesh

    support = ((_rand(3000, 3000, 20_000, 8) + sp.eye(3000)) > 0).astype(
        np.float32)
    dga, _ = pattn.shard_attention_gather(support, 4)
    ga = dga.local(Mesh(rank=2, size=4, device=cuda)).attn
    cpu = dga.local(Mesh(rank=2, size=4, device=torch.device("cpu"))).attn
    H, F = 8, 8
    gen = torch.Generator(device=cuda).manual_seed(5)
    f1 = torch.randn(dga.n_local, H, generator=gen, device=cuda)
    f2 = torch.randn(dga.n_cat, H, generator=gen, device=cuda)
    h = torch.randn(dga.n_cat, H * F, generator=gen, device=cuda)
    g = torch.randn(dga.n_local, H * F, generator=gen, device=cuda)
    gl = torch.randn(dga.n_local, H, generator=gen, device=cuda)
    before = tracing.counter("launches.gscatter_weighted")
    out = tgat_.gather_attention(ga, f1, f2, h, num_heads=H, feat=F)
    torch.cuda.synchronize()
    assert tracing.counter("launches.gscatter_weighted") == before + 1
    _close(out.cpu(), tgat_.gather_attention(
        cpu, f1.cpu(), f2.cpu(), h.cpu(), num_heads=H, feat=F), GAT_TOL)
    s_, p, live = tgat_._edge_terms(ga, f1, f2, 0.2)
    q = (torch.where(s_ >= 0, 1.0, 0.2) * torch.where(live, p, 0.0)
         ).contiguous()
    ones = torch.ones(dga.n_cat, H, device=cuda)
    for gs, s2e, wf, x, wl, items in (
            (ga.fwd, ga.slot2edge_fwd, p, tgat_._augx(h, ones, H, F), p,
             ga.items_fwd),
            (ga.bwd, ga.slot2edge_bwd, p, g, None, ga.items_bwd),
            (ga.fwd, ga.slot2edge_fwd, q, tgat_._augx(h, ones, H, F), q,
             ga.items_fwd),
            (ga.bwd, ga.slot2edge_bwd, q, tgat_._augx(g, gl, H, F), q,
             ga.items_bwd)):
        got = tgat_.gscatter_weighted(gs, s2e, wf, x, num_heads=H, wl=wl,
                                      items=items)
        _close(got, tgat_.gscatter_weighted_plain(gs, s2e, wf, x,
                                                  num_heads=H, wl=wl),
               GAT_TOL)


def test_world_of_one_train_step_matches_single_device(cuda, tmp_path):
    """build_dist_steps over NCCL at world size 1 (halo-cootile: B3 on
    the card) against the one-device step through the same kernel."""
    import torch.distributed as tdist

    from h2gcn_tpu_torch.nn import NetworkModel, parse_network_setup
    from h2gcn_tpu_torch.parallel import dist as pdist
    from h2gcn_tpu_torch.parallel import train as ptrain
    from h2gcn_tpu_torch.parallel.mesh import init_group

    a = _sym(3000, 30_000, 9)
    mats = [a, sp.csr_matrix(a @ a, dtype=np.float32)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3000, 32)).astype(np.float32))
    y = torch.eye(5)[torch.from_numpy(rng.integers(0, 5, 3000))]
    mask = torch.from_numpy(rng.random(3000) < 0.4)

    def model():
        m = NetworkModel(parse_network_setup(
            "M16-R-T1-G-V-T2-G-V-C1-C2-MO", 5, _dense_units=16),
            l2_regularize_weight=5e-4)
        return m.init(32, 2, torch.Generator().manual_seed(0), cuda)

    ref = model()
    hops = [SparseMatrix.from_scipy(m, backend="cootile", device=cuda)
            for m in mats]
    loss = ref.loss(ref(hops[0], x.to(cuda), hops), y.to(cuda),
                    mask.to(cuda))
    loss.backward()
    torch.optim.SGD(ref.parameters(), lr=0.5).step()

    mesh = init_group(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cuda")
    try:
        dm = model()
        shards, _ = pdist.shard_hops(mats, 1, mode="halo-cootile")
        train_step, _ = ptrain.build_dist_steps(
            dm, torch.optim.SGD(dm.parameters(), lr=0.5), mesh, shards)
        before = tracing.counter("launches.cootile_spmm")
        got = train_step(x.to(cuda), y.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        assert tracing.counter("launches.cootile_spmm") > before
    finally:
        tdist.destroy_process_group()
    assert abs(float(got) - float(loss.detach())) <= 1e-4 * abs(float(loss))
    for (name, p), q in zip(dm.named_parameters(), ref.parameters()):
        _close(p.detach(), q.detach(), GAT_TOL)


@pytest.mark.parametrize("config", ["h2gcn2", "gat"])
def test_readbacks_are_the_epochs_syncs(cuda, small_planetoid, tmp_path,
                                        config):
    """Five epochs of a benchmark cell's CLI (its configuration's flags;
    GAT on the gather payload, its route at the cell's size) at a small
    size under ``torch.cuda.set_sync_debug_mode("warn")``: every sync of
    the post-epoch callbacks is a ``tracing.readback``, and the counter
    ``readbacks`` counts each. The syncs inside the train and eval steps
    are printed with their call sites (``sync_site`` lines)."""
    import collections
    import json
    import warnings
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parent.parent / "benchmark"
                      / "configs" / f"{config}.json").read_text())
    cli = ["gather" if t == "auto" and config == "gat" else t
           for t in cfg["cli"]]
    args = _cli(small_planetoid, tmp_path, config, cfg["model"],
                "--epochs", "0", *cli)
    o = args.objects
    args.current_epoch, args.epochs = 0, 1 << 30
    sites = collections.Counter()

    def synced(body):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                body()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [w for w in caught if "synchroniz" in str(w.message)]

    def steps():
        o["epoch_stats"] = {}
        o["epoch_stats"].update(o["train_step"](**o["tensors"]))
        o["epoch_stats"].update(o["test_step"](**o["tensors"]))

    def post():
        for f in o["post_epoch_callbacks"]:
            f(args.current_epoch, args)

    for _ in range(5):
        args.current_epoch += 1
        for w in synced(steps):
            where = Path(w.filename)
            sites[f"{where.parent.name}/{where.name}:{w.lineno}"] += 1
        torch.cuda.synchronize()
        r0 = tracing.counter("readbacks")
        post_syncs = synced(post)
        assert len(post_syncs) == tracing.counter("readbacks") - r0 > 0
        assert {Path(w.filename).name for w in post_syncs} == {"tracing.py"}
    for site, n in sorted(sites.items()):
        print(f"sync_site {config} {site} {n / 5:g} an epoch")


def test_gcnii_train_step_matches_the_reference_on_the_card(cuda):
    """One GCNII train step at the published 64 layers of 64, set up through
    the CLI (``auto``: Ã on #1) on a 20K-node arXiv-year-shaped graph,
    against the plain reference (``benchmark/configs/gcnii.py``, the same
    seeded weights and dropout stream): the loss, and each leaf's gradient
    (from the optimizer's first moment, ``m = (1 - b1) g``) at 1e-4 of its
    largest magnitude. #1 and ``torch.sparse.mm`` sum each row in another
    order, and the error of 64 chained float32 propagations stays well under
    that, while TF32 products miss it by orders of magnitude (PERF.md
    section 6)."""
    import os
    import tempfile

    from benchmark import graphs, harness, reference

    traffic = dict(nodes=20000, edges=140000, features=128,
                   feature_kind="uniform", classes=5, degree_exponent=0.6,
                   graph_seed=0,
                   split={"kind": "random", "train": 0.5, "val": 0.25})
    cell = harness.Cell("gcnii.arxiv-year")
    seed = 2400000001
    graph = graphs.generate(traffic, seed)
    routed = tracing.counter("route.gscatter")
    with tempfile.TemporaryDirectory() as d, open(os.devnull, "w") as sink:
        prog = harness.Program(cell, graph, seed, "cuda", d, sink)
    assert tracing.counter("route.gscatter") > routed
    (l0,), n0 = _launches("gscatter_spmm"), tracing.counter("gcnii.layers")
    loss = float(prog.objects["train_step"](**prog.tensors)["train_loss"])
    assert tracing.counter("gcnii.layers") - n0 == 64
    # the 64 propagations forward and the 64 of the backward
    assert _launches("gscatter_spmm")[0] - l0 >= 128
    b1 = prog.optimizer.param_groups[0]["b1"]
    got = {k: prog.optimizer.state[p]["m"] / (1.0 - b1)
           for k, p in prog.params().items()}

    inputs = reference.Inputs(graph, cuda)
    ref = cell.reference.Model(cell.config, graph, inputs)
    ps = harness.program_seed(seed)
    params = {k: v.to(cuda).requires_grad_(True)
              for k, v in ref.init_params(ps).items()}
    logits = ref.forward(params, True,
                         torch.Generator(device=cuda).manual_seed(ps + 1))
    want = (reference.masked_cross_entropy(logits, inputs.y,
                                           inputs.train_mask)
            + ref.l2(params))
    grads = torch.autograd.grad(want, list(params.values()))
    assert abs(loss - float(want)) <= GAT_TOL * abs(float(want))
    assert set(got) == set(params)
    for k, g in zip(params, grads):
        err = float((got[k] - g).abs().max())
        assert err <= GAT_TOL * float(g.abs().max()), (k, err)

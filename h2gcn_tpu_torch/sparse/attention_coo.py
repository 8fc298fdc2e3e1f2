"""Fused multi-head graph attention over COO-chunk tables: host tables, the
CUDA kernels' wrappers, their plain PyTorch versions, and the
differentiable entry point.

The port of ``h2gcn_tpu/sparse/pallas_attention_coo.py``. It computes what
:mod:`.attention` computes over a BSR mask (per head ``k``:
``out_i = sum_j softmax_j(LeakyReLU(f1[i, k] + f2[j, k])) h[j, kF:(k+1)F]``
over the support's edges), but the support rides as per-tile edge chunks,
O(edges) bytes instead of O(tiles * T^2), so it scales past the BSR budget
with no edge-sized intermediate. Three kernels:

- :func:`coo_fwd_stats`: ``out`` and the row max ``m`` and normalizer ``l``;
- :func:`coo_bwd_row`: ``df1`` over the forward tables;
- :func:`coo_bwd_col`: ``dh`` and ``df2`` over the transpose tables (the
  same edges grouped by source tile).

Each takes padded operands (``n_pad = n_tiles * tile`` rows) and returns
padded outputs. The three walk per-row (forward, row pass) and per-column
(column pass, ``csrc/gat_attention_col.cu``) edge lists sorted once from
the tables (:func:`~.edge_items.build_edge_lists`), in work items that
spread a hub row over many warps (:func:`~.edge_items.build_edge_items`),
one launch a call (and a small merge launch when a row is split). A CPU
tensor takes the plain version beside it; a CUDA tensor launches the
kernel or raises.
:func:`gat_attention_coo` is the ``torch.autograd.Function`` over them.

Precision: ``"highest"`` is f32 throughout; ``"default"`` rounds the head
contractions' operands (the softmax weight and ``h``; ``g`` and ``h``;
alpha and ``g``) to bf16 and keeps every sum f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .attention import MAX_HF, NEG_INF, _leaky, _on_cuda, head_dots, pad_rows
from .cootile import build_chunk_tables
from .edge_items import (EDGE_BUDGET, ITEM_WARPS, ROW_COST,  # noqa: F401
                         _MAX_ITEM_ROWS, EdgeItems, build_edge_items,
                         build_edge_lists, cached_items, launch_items)

KB_FWD = 8   # the JAX package's chunks per grid step, forward and row tables
KB_COL = 8   # and transpose tables; the tables keep its kb padding
MAX_CHUNKS = 64 * 1024  # the JAX package's segment size (its SMEM budget)


@dataclasses.dataclass
class AttnCooSegment:
    """A run of chunks cut at output-tile boundaries. ``grp`` is the tile
    each chunk's output accumulates into (the destination tile for the
    forward tables, the source tile for the transpose tables), ``oth`` the
    opposite side; ``rows`` / ``cols`` are the tile-local destination row
    and source column of each slot, ``vals`` > 0 marks an edge."""

    grp: torch.Tensor       # [nchunks] int32, ascending (absolute tile)
    oth: torch.Tensor       # [nchunks] int32 (absolute tile)
    rows: torch.Tensor      # [nchunks, e_b] int32
    cols: torch.Tensor      # [nchunks, e_b] int32
    vals: torch.Tensor      # [nchunks, e_b] float32 (0 marks padding slots)
    tile_ptr: torch.Tensor  # [hi - lo + 1] int32 first chunk of each tile
    lo: int                 # first output tile
    hi: int                 # one past the last output tile


@dataclasses.dataclass
class AttnCoo:
    """Fused-attention payload: the chunk tables in both visit orders.
    ``fwd`` groups edges by destination tile (forward and row pass),
    ``bwd`` the same edges by source tile (column pass), with coordinates
    in the original (destination, source) orientation. ``fwd_ptr`` /
    ``fwd_src`` list each destination row's sources and ``col_ptr`` /
    ``col_dst`` each source column's destinations, sorted once from those
    tables; ``items`` caches their work items by (``"fwd"`` or ``"col"``,
    budget, row cost)."""

    fwd: Tuple[AttnCooSegment, ...]
    bwd: Tuple[AttnCooSegment, ...]
    tile: int = 256
    e_b: int = 128
    n: int = 0
    fwd_ptr: Optional[torch.Tensor] = None  # [n_pad + 1] int32
    fwd_src: Optional[torch.Tensor] = None  # [E] int32
    col_ptr: Optional[torch.Tensor] = None  # [n_pad + 1] int32
    col_dst: Optional[torch.Tensor] = None  # [E] int32
    items: dict = dataclasses.field(default_factory=dict)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.tile)

    @property
    def num_chunks(self) -> int:
        return sum(int(s.grp.shape[0]) for s in self.fwd)


def _segment(grp, oth, rows, cols, vals, kb, swap_coords=False,
             max_chunks: Optional[int] = None, device="cpu"):
    """Split chunk tables at group boundaries into segments of at most
    ``max_chunks`` chunks (the JAX package's SMEM segmenting; the kernels
    here take any length, so the port keeps one segment by default).

    ``swap_coords``: the transpose tables come out of build_chunk_tables
    in the transposed orientation; swap rows and cols back."""
    if swap_coords:
        rows, cols = cols, rows
    if max_chunks is None:
        max_chunks = len(grp)
    total = len(grp)
    starts = np.flatnonzero(np.diff(grp, prepend=-1))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    segs = []
    lo = 0
    while lo < total:
        hi = min(lo + max_chunks, total)
        if hi < total:
            cut = starts[(starts > lo) & (starts <= hi)]
            if len(cut):
                hi = int(cut[-1])
            else:
                nxt = starts[starts > lo]
                hi = int(nxt[0]) if len(nxt) else total
        assert (hi - lo) % kb == 0  # group chunk counts are kb multiples
        sl = slice(lo, hi)
        t_lo, t_hi = int(grp[lo]), int(grp[hi - 1]) + 1
        tile_ptr = np.searchsorted(grp[sl], np.arange(t_lo, t_hi + 1))
        segs.append(AttnCooSegment(
            grp=dev(grp[sl]), oth=dev(oth[sl]), rows=dev(rows[sl]),
            cols=dev(cols[sl]), vals=dev(vals[sl]),
            tile_ptr=dev(tile_ptr.astype(np.int32)), lo=t_lo, hi=t_hi))
        lo = hi
    return tuple(segs)


def build_attn_coo(csr, tile: int = 256, e_b: Optional[int] = 128,
                   max_chunks: Optional[int] = None, device="cpu") -> AttnCoo:
    """Host prep: (tile, e_b) chunk tables of the square attention support
    in both visit orders. Any stored value > 0 is an edge; duplicate
    entries are summed first, so each edge is one slot."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(csr, copy=True)
    csr.sum_duplicates()
    n, m = csr.shape
    if n != m:
        raise ValueError(f"attention support must be square, not {n} x {m}")
    ctr, ctc, rows, cols, vals, _, e_b = build_chunk_tables(
        csr, tile, e_b, kb=KB_FWD)
    fwd = _segment(ctr, ctc, rows, cols, vals, KB_FWD,
                   max_chunks=max_chunks, device=device)
    # the transpose tables: the same edges regrouped by source tile (built
    # for a symmetric support too: symmetry matches the tables' shapes,
    # not the chunks' contents)
    ttr, ttc, trows, tcols, tvals, _, _ = build_chunk_tables(
        csr.T.tocsr(), tile, e_b, kb=KB_COL)
    bwd = _segment(ttr, ttc, trows, tcols, tvals, KB_COL, swap_coords=True,
                   max_chunks=max_chunks, device=device)
    ac = AttnCoo(fwd=fwd, bwd=bwd, tile=tile, e_b=e_b, n=n)
    # the forward's and the column pass's edge lists, from the tables
    n_pad = ac.n_tiles * tile
    dest, src = (t.cpu().numpy() for t in coo_edges(fwd, tile))
    fwd_ptr, fwd_src = build_edge_lists(dest, src, n_pad)
    dest, src = (t.cpu().numpy() for t in coo_edges(bwd, tile,
                                                    transpose=True))
    col_ptr, col_dst = build_edge_lists(src, dest, n_pad)
    ac.fwd_ptr, ac.fwd_src, ac.col_ptr, ac.col_dst = (
        torch.from_numpy(a).to(device)
        for a in (fwd_ptr, fwd_src, col_ptr, col_dst))
    for kind in ("fwd", "col"):
        edge_items(ac, kind)
    return ac


def edge_items(ac: AttnCoo, kind: str, budget: Optional[int] = None,
               row_cost: Optional[int] = None) -> EdgeItems:
    """The work items of the forward and the row pass (``kind="fwd"``) or
    the column pass (``"col"``) at ``budget`` edges an item and ``row_cost``
    (:data:`EDGE_BUDGET` and :data:`ROW_COST` by default), built once and
    kept on ``ac``."""
    ptr = ac.fwd_ptr if kind == "fwd" else ac.col_ptr
    return cached_items(ac.items, ptr, kind, budget, row_cost)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the tables expanded to edges, then index ops, on
# padded operands. The references the kernels are held against.
# ---------------------------------------------------------------------------


def _operand(x, precision):
    """A head contraction's operand: f32, or rounded to bf16 ("default")."""
    if precision == "highest":
        return x
    if precision == "default":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def coo_edges(segs, tile: int, transpose: bool = False):
    """``(dest, src)`` int64 node indices of the tables' edges (slots with
    a value > 0). ``transpose``: the tables are grouped by source tile."""
    dest, src = [], []
    for seg in segs:
        grp = seg.grp.to(torch.int64)[:, None]
        oth = seg.oth.to(torch.int64)[:, None]
        d_tile, s_tile = (oth, grp) if transpose else (grp, oth)
        live = seg.vals > 0
        dest.append((d_tile * tile + seg.rows)[live])
        src.append((s_tile * tile + seg.cols)[live])
    return torch.cat(dest), torch.cat(src)


def _stats(f1p, f2p, dest, src, n_pad, slope):
    """Per-edge logits [E, H] and the row max m [n_pad, H] (sentinel on
    rows without an edge)."""
    e = _leaky(f1p[dest] + f2p[src], slope)
    H = f1p.shape[1]
    m = torch.full((n_pad, H), NEG_INF, dtype=torch.float32,
                   device=f1p.device)
    m = m.scatter_reduce(0, dest[:, None].expand(-1, H), e, reduce="amax",
                         include_self=True)
    return e, m


def _alpha(f1p, f2p, m, l, dest, src, slope):
    pre = f1p[dest] + f2p[src]
    alpha = torch.exp(_leaky(pre, slope) - m[dest]) / torch.clamp(
        l[dest], min=1e-16)
    return alpha, torch.where(pre >= 0, 1.0, slope)


def _sum_rows(n_rows, index, values):
    """``values`` [E, ...] summed into ``n_rows`` rows at ``index`` in
    float64, for the caller to round to float32 once: torch's CPU
    ``index_add_`` in float32 gave sums that varied from call to call on a
    loaded machine (up to 1.2e-3 in l)."""
    out = torch.zeros((n_rows,) + tuple(values.shape[1:]), dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, index, values.double())


def coo_fwd_stats_plain(ac: AttnCoo, f1p, f2p, hp, *, num_heads: int,
                        feat: int, slope: float = 0.2,
                        precision: str = "highest"):
    """-> ``(out [n_pad, H*F], m [n_pad, H], l [n_pad, H])``; the sums run
    in float64 and are rounded to float32 once."""
    H, F = num_heads, feat
    n_pad = hp.shape[0]
    dest, src = coo_edges(ac.fwd, ac.tile)
    e, m = _stats(f1p, f2p, dest, src, n_pad, slope)
    p = torch.exp(e - m[dest])
    l = _sum_rows(n_pad, dest, p)
    contrib = (_operand(p, precision)[:, :, None]
               * _operand(hp[src], precision).reshape(-1, H, F))
    acc = _sum_rows(n_pad, dest, contrib)
    out = (acc / torch.clamp(l, min=1e-16)[:, :, None]).float()
    return out.reshape(n_pad, H * F), m, l.float()


def coo_bwd_row_plain(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *,
                      num_heads: int, feat: int, slope: float = 0.2,
                      precision: str = "highest"):
    """-> ``df1 [n_pad, H]``: sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij,
    summed in float64 and rounded to float32 once."""
    H, F = num_heads, feat
    dest, src = coo_edges(ac.fwd, ac.tile)
    alpha, dleaky = _alpha(f1p, f2p, m, l, dest, src, slope)
    gh = (_operand(gp[dest], precision)
          * _operand(hp[src], precision)).reshape(-1, H, F).sum(dim=2)
    dpre = alpha * (gh - d[dest]) * dleaky
    return _sum_rows(f1p.shape[0], dest, dpre).float()


def coo_bwd_col_plain(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *,
                      num_heads: int, feat: int, slope: float = 0.2,
                      precision: str = "highest"):
    """-> ``(dh [n_pad, H*F], df2 [n_pad, H])`` over the transpose tables:
    dh_j = sum_i alpha_ij g_i and df2_j = sum_i alpha_ij (g_i . h_j - D_i)
    leaky'_ij, summed in float64 and rounded to float32 once."""
    H, F = num_heads, feat
    dest, src = coo_edges(ac.bwd, ac.tile, transpose=True)
    alpha, dleaky = _alpha(f1p, f2p, m, l, dest, src, slope)
    g_e = _operand(gp[dest], precision).reshape(-1, H, F)
    dh = _sum_rows(hp.shape[0], src, (_operand(alpha, precision)[:, :, None]
                                      * g_e).reshape(-1, H * F))
    gh = (g_e * _operand(hp[src], precision).reshape(-1, H, F)).sum(dim=2)
    dpre = alpha * (gh - d[dest]) * dleaky
    return dh.float(), _sum_rows(f2p.shape[0], src, dpre).float()


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check(name, ac: AttnCoo, num_heads, feat, precision, **tensors):
    """The kernels' contract, checked before a launch; raises ValueError."""
    H, F = num_heads, feat
    n_pad = ac.n_tiles * ac.tile
    if H < 1 or F < 1 or H * F > MAX_HF:
        raise ValueError(f"{name}: H*F = {H}*{F} is outside the kernel's "
                         f"limit 1..{MAX_HF}")
    if precision not in ("highest", "default"):
        raise ValueError(f"{name}: unknown precision {precision!r}")
    widths = {"f1": H, "f2": H, "h": H * F, "g": H * F, "m": H, "l": H,
              "d": H}
    device = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.shape != (n_pad, widths[key]) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 "
                             f"[{n_pad}, {widths[key]}], not {t.dtype} "
                             f"{tuple(t.shape)}")
    lists = [ac.fwd_ptr, ac.fwd_src, ac.col_ptr, ac.col_dst]
    for t in [*tensors.values(), *lists]:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             f"{device}")
    return n_pad


def _launch_items(wrapper, fn, ac, kind, num_heads, feat, slope, precision,
                  items, warps, tensors, ws_floats):
    """Launch ``fn`` over the payload's lists of ``kind`` and their work
    items (``items``, or :func:`edge_items`' default) with ``warps`` items a
    block (:func:`~.edge_items.launch_items`)."""
    it = edge_items(ac, kind) if items is None else items
    if it.kind != kind:
        raise ValueError(f"{wrapper.__name__}: needs the {kind!r} work "
                         f"items, not {it.kind!r}")
    ptr, other = ((ac.fwd_ptr, ac.fwd_src) if kind == "fwd"
                  else (ac.col_ptr, ac.col_dst))
    launch_items(wrapper, fn, ptr, other, it, tensors, ws_floats,
                 num_heads=num_heads, feat=feat, slope=slope,
                 precision=precision, warps=warps)


def coo_fwd_stats(ac: AttnCoo, f1p, f2p, hp, *, num_heads: int, feat: int,
                  slope: float = 0.2, precision: str = "highest",
                  items: Optional[EdgeItems] = None,
                  warps: Optional[int] = None):
    """Forward with stats on padded operands -> ``(out, m, l)``. A CPU
    tensor takes :func:`coo_fwd_stats_plain`; a CUDA tensor launches
    ``h2gcn_gat_coo_fwd`` or raises. ``items`` (``edge_items(ac, "fwd",
    ...)``) and ``warps`` (items a thread block) default to the payload's
    items at :data:`EDGE_BUDGET` and :data:`ITEM_WARPS`."""
    kw = dict(num_heads=num_heads, feat=feat, slope=slope,
              precision=precision)
    if not _on_cuda("coo_fwd_stats", hp):
        return coo_fwd_stats_plain(ac, f1p, f2p, hp, **kw)
    n_pad = _check("coo_fwd_stats", ac, num_heads, feat, precision, f1=f1p,
                   f2=f2p, h=hp)
    out = torch.empty(n_pad, num_heads * feat, dtype=torch.float32,
                      device=hp.device)
    m = torch.empty(n_pad, num_heads, dtype=torch.float32, device=hp.device)
    l = torch.empty_like(m)
    _launch_items(coo_fwd_stats, "h2gcn_gat_coo_fwd", ac, "fwd",
                  items=items, warps=warps,
                  tensors=(f1p, f2p, hp, out, m, l),
                  ws_floats=num_heads * (2 + feat), **kw)
    return out, m, l


def coo_bwd_row(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                feat: int, slope: float = 0.2, precision: str = "highest",
                items: Optional[EdgeItems] = None,
                warps: Optional[int] = None):
    """Row backward pass on padded operands -> ``df1``. A CPU tensor takes
    :func:`coo_bwd_row_plain`; a CUDA tensor launches
    ``h2gcn_gat_coo_bwd_row`` over the forward's per-row lists and work
    items or raises. ``items`` (``edge_items(ac, "fwd", ...)``) and
    ``warps`` as for :func:`coo_fwd_stats`."""
    kw = dict(num_heads=num_heads, feat=feat, slope=slope,
              precision=precision)
    if not _on_cuda("coo_bwd_row", hp):
        return coo_bwd_row_plain(ac, f1p, f2p, hp, gp, m, l, d, **kw)
    n_pad = _check("coo_bwd_row", ac, num_heads, feat, precision, f1=f1p,
                   f2=f2p, h=hp, g=gp, m=m, l=l, d=d)
    df1 = torch.empty(n_pad, num_heads, dtype=torch.float32,
                      device=hp.device)
    _launch_items(coo_bwd_row, "h2gcn_gat_coo_bwd_row", ac, "fwd",
                  items=items, warps=warps,
                  tensors=(f1p, f2p, hp, gp, m, l, d, df1),
                  ws_floats=num_heads, **kw)
    return df1


def coo_bwd_col(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                feat: int, slope: float = 0.2, precision: str = "highest",
                items: Optional[EdgeItems] = None,
                warps: Optional[int] = None):
    """Column backward pass on padded operands -> ``(dh, df2)``. A CPU
    tensor takes :func:`coo_bwd_col_plain` (over the transpose tables); a
    CUDA tensor launches ``h2gcn_gat_coo_bwd_col`` over the per-column
    lists or raises. ``items`` (``edge_items(ac, "col", ...)``) and
    ``warps`` as for :func:`coo_fwd_stats`."""
    kw = dict(num_heads=num_heads, feat=feat, slope=slope,
              precision=precision)
    if not _on_cuda("coo_bwd_col", hp):
        return coo_bwd_col_plain(ac, f1p, f2p, hp, gp, m, l, d, **kw)
    n_pad = _check("coo_bwd_col", ac, num_heads, feat, precision, f1=f1p,
                   f2=f2p, h=hp, g=gp, m=m, l=l, d=d)
    dh = torch.empty(n_pad, num_heads * feat, dtype=torch.float32,
                     device=hp.device)
    df2 = torch.empty(n_pad, num_heads, dtype=torch.float32,
                      device=hp.device)
    _launch_items(coo_bwd_col, "h2gcn_gat_coo_bwd_col", ac, "col",
                  items=items, warps=warps,
                  tensors=(f1p, f2p, hp, gp, m, l, d, dh, df2),
                  ws_floats=num_heads * (1 + feat), **kw)
    return dh, df2


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def coo_gat_attention(ac: AttnCoo, f1, f2, h, *, num_heads: int, feat: int,
                      n_out: int, slope: float = 0.2,
                      precision: str = "highest") -> torch.Tensor:
    """Fused attention over the COO-chunk tables, forward only:
    ``[n_out, H*F]``."""
    n_pad = ac.n_tiles * ac.tile
    out, _, _ = coo_fwd_stats(ac, pad_rows(f1, n_pad), pad_rows(f2, n_pad),
                              pad_rows(h, n_pad), num_heads=num_heads,
                              feat=feat, slope=slope, precision=precision)
    return out[:n_out]


class _GATAttentionCoo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, h, ac, num_heads, feat, n_out, slope,
                precision):
        n_pad = ac.n_tiles * ac.tile
        f1p, f2p, hp = (pad_rows(t, n_pad) for t in (f1, f2, h))
        out, m, l = coo_fwd_stats(ac, f1p, f2p, hp, num_heads=num_heads,
                                  feat=feat, slope=slope, precision=precision)
        ctx.save_for_backward(f1p, f2p, hp, out, m, l)
        ctx.conf = (ac, num_heads, feat, slope, precision,
                    f1.shape[0], f2.shape[0], h.shape[0])
        return out[:n_out]

    @staticmethod
    def backward(ctx, g):
        f1p, f2p, hp, out, m, l = ctx.saved_tensors
        ac, num_heads, feat, slope, precision, n1, n2, nh = ctx.conf
        gp = pad_rows(g, out.shape[0])
        # recomputes alpha from the saved (m, l); D = g . out per head
        d = head_dots(gp, out, num_heads, feat)
        kw = dict(num_heads=num_heads, feat=feat, slope=slope,
                  precision=precision)
        df1 = coo_bwd_row(ac, f1p, f2p, hp, gp, m, l, d, **kw)
        dh, df2 = coo_bwd_col(ac, f1p, f2p, hp, gp, m, l, d, **kw)
        return (df1[:n1], df2[:n2], dh[:nh]) + (None,) * 6


def gat_attention_coo(ac: AttnCoo, f1, f2, h, *, num_heads: int, feat: int,
                      n_out: int, slope: float = 0.2,
                      precision: str = "highest") -> torch.Tensor:
    """Differentiable fused attention over COO-chunk tables: the forward
    kernel, and a two-pass backward (row pass for df1, column pass over
    the transpose tables for dh and df2). ``f1, f2: [n, H]``, ``h: [n,
    H*F]`` -> ``[n_out, H*F]``."""
    return _GATAttentionCoo.apply(f1, f2, h, ac, num_heads, feat, n_out,
                                  slope, precision)

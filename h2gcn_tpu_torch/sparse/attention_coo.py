"""Fused multi-head graph attention over COO-chunk tables: host tables, the
CUDA kernels' wrappers, their plain PyTorch versions, and the
differentiable entry point.

The port of ``h2gcn_tpu/sparse/pallas_attention_coo.py``. It computes what
:mod:`.attention` computes over a BSR mask (per head ``k``:
``out_i = sum_j softmax_j(LeakyReLU(f1[i, k] + f2[j, k])) h[j, kF:(k+1)F]``
over the support's edges), but the support rides as per-tile edge chunks,
O(edges) bytes instead of O(tiles * T^2), so it scales past the BSR budget
with no edge-sized intermediate. Three kernels of
``csrc/gat_attention_coo.cu``:

- :func:`coo_fwd_stats`: ``out`` and the row max ``m`` and normalizer ``l``;
- :func:`coo_bwd_row`: ``df1`` over the forward tables;
- :func:`coo_bwd_col`: ``dh`` and ``df2`` over the transpose tables (the
  same edges grouped by source tile).

Each takes padded operands (``n_pad = n_tiles * tile`` rows) and returns
padded outputs, launching once per table segment. A CPU tensor takes the
plain version beside it; a CUDA tensor launches the kernel or raises.
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

from . import _build
from .attention import (MAX_HF, NEG_INF, _leaky, _on_cuda, _stream,
                        head_dots, pad_rows)
from .cootile import build_chunk_tables

KB_FWD = 8   # the JAX package's chunks per grid step, forward and row tables
KB_COL = 8   # and transpose tables; the tables keep its kb padding
MAX_CHUNKS = 64 * 1024  # the JAX package's segment size (its SMEM budget)
_MAX_TILE = 1024    # csrc/gat_attention_coo.cu's limit on T
_SMEM_BYTES = 227 * 1024  # shared memory one thread block may take
_WARPS = 8          # csrc/gat_edge.cuh kWarps


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
    max_tile_slots: int = 0  # the most slots one output tile holds


@dataclasses.dataclass
class AttnCoo:
    """Fused-attention payload: the chunk tables in both visit orders.
    ``fwd`` groups edges by destination tile (forward and row pass),
    ``bwd`` the same edges by source tile (column pass), with coordinates
    in the original (destination, source) orientation."""

    fwd: Tuple[AttnCooSegment, ...]
    bwd: Tuple[AttnCooSegment, ...]
    tile: int = 256
    e_b: int = 128
    n: int = 0

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
    e_b = rows.shape[1]

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
            tile_ptr=dev(tile_ptr.astype(np.int32)), lo=t_lo, hi=t_hi,
            max_tile_slots=int(np.diff(tile_ptr).max()) * e_b))
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
    return AttnCoo(fwd=fwd, bwd=bwd, tile=tile, e_b=e_b, n=n)


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


def coo_fwd_stats_plain(ac: AttnCoo, f1p, f2p, hp, *, num_heads: int,
                        feat: int, slope: float = 0.2,
                        precision: str = "highest"):
    """-> ``(out [n_pad, H*F], m [n_pad, H], l [n_pad, H])``."""
    H, F = num_heads, feat
    n_pad = hp.shape[0]
    dest, src = coo_edges(ac.fwd, ac.tile)
    e, m = _stats(f1p, f2p, dest, src, n_pad, slope)
    p = torch.exp(e - m[dest])
    l = torch.zeros(n_pad, H, dtype=torch.float32,
                    device=hp.device).index_add_(0, dest, p)
    contrib = (_operand(p, precision)[:, :, None]
               * _operand(hp[src], precision).reshape(-1, H, F))
    acc = torch.zeros(n_pad, H, F, dtype=torch.float32,
                      device=hp.device).index_add_(0, dest, contrib)
    out = acc / torch.clamp(l, min=1e-16)[:, :, None]
    return out.reshape(n_pad, H * F), m, l


def coo_bwd_row_plain(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *,
                      num_heads: int, feat: int, slope: float = 0.2,
                      precision: str = "highest"):
    """-> ``df1 [n_pad, H]``: sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij."""
    H, F = num_heads, feat
    dest, src = coo_edges(ac.fwd, ac.tile)
    alpha, dleaky = _alpha(f1p, f2p, m, l, dest, src, slope)
    gh = (_operand(gp[dest], precision)
          * _operand(hp[src], precision)).reshape(-1, H, F).sum(dim=2)
    dpre = alpha * (gh - d[dest]) * dleaky
    return torch.zeros_like(f1p).index_add_(0, dest, dpre)


def coo_bwd_col_plain(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *,
                      num_heads: int, feat: int, slope: float = 0.2,
                      precision: str = "highest"):
    """-> ``(dh [n_pad, H*F], df2 [n_pad, H])`` over the transpose tables:
    dh_j = sum_i alpha_ij g_i and df2_j = sum_i alpha_ij (g_i . h_j - D_i)
    leaky'_ij."""
    H, F = num_heads, feat
    dest, src = coo_edges(ac.bwd, ac.tile, transpose=True)
    alpha, dleaky = _alpha(f1p, f2p, m, l, dest, src, slope)
    g_e = _operand(gp[dest], precision).reshape(-1, H, F)
    dh = torch.zeros_like(hp).index_add_(
        0, src, (_operand(alpha, precision)[:, :, None] * g_e).reshape(
            -1, H * F))
    gh = (g_e * _operand(hp[src], precision).reshape(-1, H, F)).sum(dim=2)
    dpre = alpha * (gh - d[dest]) * dleaky
    return dh, torch.zeros_like(f2p).index_add_(0, src, dpre)


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
    if ac.tile % 32 or ac.tile > _MAX_TILE:
        raise ValueError(f"{name}: tile {ac.tile} is not a multiple of 32 "
                         f"up to {_MAX_TILE}")
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
    tables = [t for seg in ac.fwd + ac.bwd for t in (
        seg.grp, seg.oth, seg.rows, seg.cols, seg.vals, seg.tile_ptr)]
    for t in [*tensors.values(), *tables]:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             f"{device}")
    return n_pad


def _list_place(seg: AttnCooSegment, scratch_floats: int, tile: int,
                device):
    """Where the kernel keeps a tile's bucketed edge list: ``(ws,
    list_slots)``; in shared memory when the segment's fullest tile fits
    beside the warps' scratch and the per-row starts, else in a workspace
    with a slot for each of the segment's slots."""
    fixed = 4 * (_WARPS * scratch_floats + 2 * tile + 1)
    if fixed + 4 * seg.max_tile_slots <= _SMEM_BYTES:
        return None, seg.max_tile_slots
    return torch.empty(seg.vals.numel(), dtype=torch.int32, device=device), 0


def _launch(wrapper, fn, segs, ac, num_heads, feat, slope, precision,
            scratch, tensors):
    """Launch ``fn`` once per segment of ``segs`` on ``tensors`` (data
    pointers, in the launcher's order), raising on a launch error and
    counting each launch on ``wrapper``."""
    lib, _ = _build.library()
    ref = tensors[0]
    for seg in segs:
        ws, list_slots = _list_place(seg, scratch, ac.tile, ref.device)
        err = getattr(lib, fn)(
            seg.tile_ptr.data_ptr(), seg.oth.data_ptr(), seg.rows.data_ptr(),
            seg.cols.data_ptr(), seg.vals.data_ptr(),
            None if ws is None else ws.data_ptr(),
            *(t.data_ptr() for t in tensors), seg.lo, seg.hi - seg.lo,
            ac.tile, ac.e_b, list_slots, num_heads, feat, slope,
            int(precision == "default"), _stream(ref))
        _build.check(lib, err, wrapper.__name__)
        wrapper.launches += 1


def coo_fwd_stats(ac: AttnCoo, f1p, f2p, hp, *, num_heads: int, feat: int,
                  slope: float = 0.2, precision: str = "highest"):
    """Forward with stats on padded operands -> ``(out, m, l)``. A CPU
    tensor takes :func:`coo_fwd_stats_plain`; a CUDA tensor launches
    ``h2gcn_gat_coo_fwd`` (once per segment) or raises."""
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
    _launch(coo_fwd_stats, "h2gcn_gat_coo_fwd", ac.fwd, ac,
            scratch=2 * num_heads, tensors=(f1p, f2p, hp, out, m, l), **kw)
    return out, m, l


def coo_bwd_row(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                feat: int, slope: float = 0.2, precision: str = "highest"):
    """Row backward pass on padded operands -> ``df1``. A CPU tensor takes
    :func:`coo_bwd_row_plain`; a CUDA tensor launches
    ``h2gcn_gat_coo_bwd_row`` or raises."""
    kw = dict(num_heads=num_heads, feat=feat, slope=slope,
              precision=precision)
    if not _on_cuda("coo_bwd_row", hp):
        return coo_bwd_row_plain(ac, f1p, f2p, hp, gp, m, l, d, **kw)
    n_pad = _check("coo_bwd_row", ac, num_heads, feat, precision, f1=f1p,
                   f2=f2p, h=hp, g=gp, m=m, l=l, d=d)
    df1 = torch.empty(n_pad, num_heads, dtype=torch.float32,
                      device=hp.device)
    _launch(coo_bwd_row, "h2gcn_gat_coo_bwd_row", ac.fwd, ac,
            scratch=num_heads * feat,
            tensors=(f1p, f2p, hp, gp, m, l, d, df1), **kw)
    return df1


def coo_bwd_col(ac: AttnCoo, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                feat: int, slope: float = 0.2, precision: str = "highest"):
    """Column backward pass on padded operands over the transpose tables
    -> ``(dh, df2)``. A CPU tensor takes :func:`coo_bwd_col_plain`; a CUDA
    tensor launches ``h2gcn_gat_coo_bwd_col`` or raises."""
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
    _launch(coo_bwd_col, "h2gcn_gat_coo_bwd_col", ac.bwd, ac,
            scratch=num_heads + num_heads * feat,
            tensors=(f1p, f2p, hp, gp, m, l, d, dh, df2), **kw)
    return dh, df2


# kernel launches; chip_smoke.py reads them
coo_fwd_stats.launches = 0
coo_bwd_row.launches = 0
coo_bwd_col.launches = 0


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

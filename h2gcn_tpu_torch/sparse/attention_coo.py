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
padded outputs. The row pass launches once per table segment; the forward
and the column pass walk per-row and per-column edge lists sorted once from
the same tables (:func:`build_edge_lists`), in work items that spread a hub
row over many warps (:func:`build_edge_items`), one launch a call (and a
small merge launch when a row is split). A CPU tensor takes the plain
version beside it; a CUDA tensor launches the kernel or raises.
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
# The forward's and the column pass's work items: edges one item (one
# warp) walks at most, items a thread block, and what a row costs an item
# beside its edges, in edges (a warp walks its rows one after another,
# each a chain of dependent loads); from chip_smoke.py's coo_sweep on the
# H100 (PERF.md)
EDGE_BUDGET = 128
ITEM_WARPS = 4
ROW_COST = 16
_MAX_ITEM_WARPS = 16  # csrc/gat_attention_coo.cu kMaxItemWarps
_MAX_ITEM_ROWS = 32   # rows one item walks at most (the kernels' limit)


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
class EdgeItems:
    """The work items of the forward (over the per-row lists) or the column
    pass (per-column lists): each item is one warp's walk. ``items[i] =
    (lo, hi, e_lo, e_hi)``: rows ``lo .. hi``, clipped to list positions
    ``e_lo .. e_hi``; either a run of whole rows or one piece of a split
    row, whose partial state goes to workspace slot ``slot[i]`` (-1 for
    whole rows). Split row ``split_rows[s]`` has slots ``split_ptr[s] ..
    split_ptr[s + 1]``."""

    items: torch.Tensor       # [I, 4] int32
    slot: torch.Tensor        # [I] int32
    split_rows: torch.Tensor  # [S] int32
    split_ptr: torch.Tensor   # [S + 1] int32
    kind: str                 # "fwd" (per-row lists) or "col"
    budget: int
    row_cost: int
    n_pieces: int             # workspace slots: split_ptr[-1]

    @property
    def n_items(self) -> int:
        return int(self.items.shape[0])

    @property
    def n_split(self) -> int:
        return int(self.split_rows.shape[0])


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


def build_edge_lists(key, other, n_rows: int):
    """Edges grouped by ``key`` (numpy only): ``(ptr [n_rows + 1], other
    [E])``, both int32; the edges of key ``r`` have their other ends at
    ``other[ptr[r]:ptr[r + 1]]``, in the order given (a stable sort)."""
    key = np.asarray(key, np.int64)
    order = np.argsort(key, kind="stable")
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=n_rows), out=ptr[1:])
    return (ptr.astype(np.int32),
            np.asarray(other, np.int64)[order].astype(np.int32))


def build_edge_items(ptr, budget: int, row_cost: int = ROW_COST,
                     max_rows: int = _MAX_ITEM_ROWS):
    """The kernels' work items over per-row lists ``ptr`` (numpy only).

    Whole rows are packed into one item while their edges plus
    ``row_cost`` a row stay within ``budget`` (at least one row an item, at
    most ``max_rows``); a row of more than ``budget`` edges is cut into
    ``ceil(deg / budget)`` near-equal pieces of its own. Every row
    ``0 .. len(ptr) - 1``, with or without edges, lies in exactly one item
    or is split. Returns ``(items [I, 4], slot [I], split_rows [S],
    split_ptr [S + 1])``, all int32, as :class:`EdgeItems` holds them."""
    ptr = np.asarray(ptr, np.int64)
    n = len(ptr) - 1
    deg = np.diff(ptr)
    budget = max(1, int(budget))
    big = np.flatnonzero(deg > budget)
    cost = ptr + int(row_cost) * np.arange(n + 1)  # cumulative item cost
    items, slot, split_rows, split_ptr = [], [], [], [0]
    r = 0
    while r < n:
        if deg[r] > budget:
            k = -(-int(deg[r]) // budget)
            cuts = ptr[r] + (np.arange(k + 1) * deg[r]) // k
            items.extend((r, r + 1, cuts[p], cuts[p + 1]) for p in range(k))
            slot.extend(range(split_ptr[-1], split_ptr[-1] + k))
            split_rows.append(r)
            split_ptr.append(split_ptr[-1] + k)
            r += 1
            continue
        nxt = np.searchsorted(big, r)
        hi = min(n, r + max_rows, int(big[nxt]) if nxt < len(big) else n)
        fit = int(np.searchsorted(cost, cost[r] + budget, side="right")) - 1
        r1 = max(r + 1, min(fit, hi))
        items.append((r, r1, ptr[r], ptr[r1]))
        slot.append(-1)
        r = r1
    return (np.asarray(items, np.int32).reshape(-1, 4),
            np.asarray(slot, np.int32), np.asarray(split_rows, np.int32),
            np.asarray(split_ptr, np.int32))


def edge_items(ac: AttnCoo, kind: str, budget: Optional[int] = None,
               row_cost: Optional[int] = None) -> EdgeItems:
    """The work items of the forward (``kind="fwd"``) or the column pass
    (``"col"``) at ``budget`` edges an item and ``row_cost``
    (:data:`EDGE_BUDGET` and :data:`ROW_COST` by default), built once and
    kept on ``ac``."""
    budget = EDGE_BUDGET if budget is None else int(budget)
    row_cost = ROW_COST if row_cost is None else int(row_cost)
    key = (kind, budget, row_cost)
    if key not in ac.items:
        ptr = ac.fwd_ptr if kind == "fwd" else ac.col_ptr
        parts = build_edge_items(ptr.cpu().numpy(), budget, row_cost)
        ac.items[key] = EdgeItems(
            *(torch.from_numpy(a).to(ptr.device) for a in parts),
            kind=kind, budget=budget, row_cost=row_cost,
            n_pieces=int(parts[3][-1]))
    return ac.items[key]


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
        seg.grp, seg.oth, seg.rows, seg.cols, seg.vals, seg.tile_ptr)] + [
            ac.fwd_ptr, ac.fwd_src, ac.col_ptr, ac.col_dst]
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
    """Launch ``fn`` (the row pass) once per segment of ``segs`` on
    ``tensors`` (data pointers, in the launcher's order), raising on a
    launch error and counting each launch on ``wrapper``."""
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


def _launch_items(wrapper, fn, ac, kind, num_heads, feat, slope, precision,
                  items, warps, tensors, ws_floats):
    """Launch ``fn`` over the work items of ``kind`` (``items``, or
    :func:`edge_items`' default) with ``warps`` items a block on
    ``tensors`` (data pointers, in the launcher's order) and a workspace of
    ``ws_floats`` a split row's piece; raises on a launch error and counts
    the launch on ``wrapper`` (its merge launch, when a row is split, is
    part of it)."""
    name = wrapper.__name__
    warps = ITEM_WARPS if warps is None else int(warps)
    if not 1 <= warps <= _MAX_ITEM_WARPS:
        raise ValueError(f"{name}: warps {warps} is outside "
                         f"1..{_MAX_ITEM_WARPS}")
    it = edge_items(ac, kind) if items is None else items
    if it.kind != kind:
        raise ValueError(f"{name}: needs the {kind!r} work items, not "
                         f"{it.kind!r}")
    ptr, other = ((ac.fwd_ptr, ac.fwd_src) if kind == "fwd"
                  else (ac.col_ptr, ac.col_dst))
    ref = tensors[0]
    ws = (torch.empty(it.n_pieces * ws_floats, dtype=torch.float32,
                      device=ref.device) if it.n_pieces else None)
    lib, _ = _build.library()
    err = getattr(lib, fn)(
        it.items.data_ptr(), it.slot.data_ptr(), it.split_rows.data_ptr(),
        it.split_ptr.data_ptr(), ptr.data_ptr(), other.data_ptr(),
        *(t.data_ptr() for t in tensors),
        None if ws is None else ws.data_ptr(), it.n_items, it.n_split,
        num_heads, feat, slope, int(precision == "default"), warps,
        _stream(ref))
    _build.check(lib, err, wrapper.__name__)
    wrapper.launches += 1


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

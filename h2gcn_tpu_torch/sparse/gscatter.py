"""Gather-scatter SpMM for the ultra-sparse regime: host tables, the CUDA
kernel's wrapper, and its plain PyTorch version.

The tables are those of ``h2gcn_tpu/sparse/pallas_gscatter.py``, built the
same way so the two packages can be compared table for table: edges are
grouped by 512-row destination stripe, sorted by source column inside each
stripe, cut into ``e_b``-slot chunks, and each stripe's chunk list is padded
to a multiple of ``kb`` (one TPU grid step) with at least one step per
stripe, so every output row is written. Segments cap the steps per launch,
and a stripe with more than ``max_steps`` steps (a mega-hub) spills into
overflow levels whose outputs are summed.

:func:`gscatter_spmm` launches ``csrc/gscatter.cu`` on a CUDA tensor and
takes :func:`gscatter_spmm_plain` only for a CPU tensor. The kernel's thread
blocks walk work items that :func:`build_schedule` cuts from a segment's
``chunk_ptr``, beside the tables (which stay those of the JAX package).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

_KB = 8          # chunks per step (a TPU grid step; kept for table parity)
_MAX_STEPS = 2048  # steps per segment
# the kernel's shared stripe is tile x width f32, width the features of one
# thread block (32, 64 or 128): at most the 227 KB a block can have
_MAX_SHARED = 232448
_MAX_TILE = 1024
# the widest feature tile the kernel takes where the stripe still fits, and
# the stripe tile of the SpMM payload (SparseMatrix.from_scipy): the fastest
# at the 10K-node A2 on the H100 (PERF.md, section 6); the table builders
# keep the JAX package's default tile
FEAT_WIDTH = 128
SPMM_TILE = 128
# table slots one work item walks at most (chunks = this // e_b): its flush
# of up to tile x width outputs stays small beside its edges' gathers
_SLOTS_PER_ITEM = 16384
# ...but a small segment gets smaller items, so that the grid still holds
# this many thread blocks per SM
_MIN_BLOCKS_PER_SM = 4


@dataclasses.dataclass
class GScatterSegment:
    ctr: torch.Tensor     # [nsteps] int32 stripe of each step (relative to rb_lo)
    rows: torch.Tensor    # [nchunks, e_b] int32 stripe-local dest rows
    cols: torch.Tensor    # [nchunks * e_b] int32 global source cols
    vals: torch.Tensor    # [nchunks, e_b] float32 (0 marks padding slots)
    chunk_ptr: torch.Tensor  # [rb_span + 1] int32 first chunk of each stripe
    rb_lo: int
    rb_hi: int
    # global slot range [slot_lo, slot_hi) of this segment before its tail
    # padding (callers that scatter per-edge values into the slot space)
    slot_lo: int = 0
    slot_hi: int = 0
    # the kernel's work items by chunk budget (build_schedule), on the
    # tables' device; filled at the first launch
    schedules: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)


@dataclasses.dataclass
class GScatter:
    segments: Tuple[GScatterSegment, ...]
    tile: int = 512
    e_b: int = 128
    kb: int = _KB
    n_rows: int = 0
    n_cols: int = 0
    overflow: Tuple["GScatter", ...] = ()

    @property
    def num_chunks(self) -> int:
        return sum(int(s.rows.shape[0]) for s in self.segments)

    @property
    def max_segment_steps(self) -> int:
        own = max(int(s.ctr.shape[0]) for s in self.segments)
        return max([own] + [o.max_segment_steps for o in self.overflow])


def build_gscatter(csr, tile: int = 512, e_b: int = 128, kb: int = _KB,
                   device="cpu") -> GScatter:
    """Host prep from a scipy matrix: see :func:`build_gscatter_coo`."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(csr)
    coo = csr.tocoo()
    return build_gscatter_coo(coo.row, coo.col, coo.data, csr.shape,
                              tile=tile, e_b=e_b, kb=kb, device=device)


def build_gscatter_coo(row, col, data, shape, tile: int = 512,
                       e_b: int = 128, kb: int = _KB,
                       return_slots: bool = False,
                       max_steps: Optional[int] = None, device="cpu"):
    """Chunk tables from raw COO arrays (any edge order).

    With ``return_slots=True`` also returns ``slots``: ``slots[k]`` is the
    global slot of input edge ``k`` in the concatenated (pre-padding) slot
    space. That path keeps one slot space, so instead of overflow levels it
    makes one over-long segment for a mega-hub stripe and warns.
    """
    n, m = shape
    n_rb = -(-n // tile)
    if max_steps is None:
        max_steps = _MAX_STEPS
    # within each destination stripe, edges sorted by source column: the
    # x row gathers of a stripe then walk x in order
    order = np.lexsort((np.asarray(col), np.asarray(row) // tile))
    r = np.asarray(row)[order].astype(np.int64)
    c = np.asarray(col)[order].astype(np.int64)
    v = np.asarray(data)[order].astype(np.float32)
    grp = r // tile

    counts = np.bincount(grp, minlength=n_rb)
    cap_edges = max_steps * kb * e_b
    if not return_slots and (counts > cap_edges).any():
        starts0 = np.concatenate([[0], np.cumsum(counts)])
        pos0 = np.arange(len(r)) - starts0[grp]
        level = pos0 // cap_edges
        levels = []
        for lv in range(1, int(level.max()) + 1):
            sel = level == lv
            levels.append(build_gscatter_coo(
                r[sel], c[sel], v[sel], shape, tile=tile, e_b=e_b, kb=kb,
                max_steps=max_steps, device=device))
        sel = level == 0
        main = build_gscatter_coo(r[sel], c[sel], v[sel], shape, tile=tile,
                                  e_b=e_b, kb=kb, max_steps=max_steps,
                                  device=device)
        return dataclasses.replace(main, overflow=tuple(levels))
    chunks_per_row = np.maximum(-(-counts // e_b), 1)   # >= 1: output init
    chunks_per_row = -(-chunks_per_row // kb) * kb      # kb alignment
    chunk_offset = np.concatenate([[0], np.cumsum(chunks_per_row)])
    total = int(chunk_offset[-1])

    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(r)) - starts[grp]
    slot = (chunk_offset[grp] * e_b + pos).astype(np.int64)

    rows = np.zeros(total * e_b, np.int32)
    cols = np.zeros(total * e_b, np.int32)
    vals = np.zeros(total * e_b, np.float32)
    rows[slot] = (r % tile).astype(np.int32)
    cols[slot] = c.astype(np.int32)
    vals[slot] = v
    ctr_chunk = np.repeat(np.arange(n_rb, dtype=np.int32), chunks_per_row)
    rows = rows.reshape(total, e_b)
    vals = vals.reshape(total, e_b)

    # segments of at most max_steps steps, cut at stripe boundaries and
    # padded to one uniform step count with weight-0 steps on their last
    # stripe
    ctr_step = ctr_chunk[::kb]
    nsteps = len(ctr_step)
    row_starts = np.flatnonzero(np.diff(ctr_step, prepend=-1))
    bounds = []
    lo = 0
    while lo < nsteps:
        hi = min(lo + max_steps, nsteps)
        if hi < nsteps:
            cut = row_starts[(row_starts > lo) & (row_starts <= hi)]
            if len(cut):
                hi = int(cut[-1])
            else:
                # one stripe spans more than max_steps steps; only the
                # return_slots path reaches here (see the docstring)
                nxt = row_starts[row_starts > lo]
                hi = int(nxt[0]) if len(nxt) else nsteps
                warnings.warn(
                    f"gscatter: tile row spans {hi - lo} steps "
                    f"(> max_steps={max_steps}); segment buffer bound "
                    "exceeded for this stripe")
        bounds.append((lo, hi))
        lo = hi
    uniform = max(hi - lo for lo, hi in bounds)
    segments = []

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for lo, hi in bounds:
        rb_lo, rb_hi = int(ctr_step[lo]), int(ctr_step[hi - 1]) + 1
        cl, ch = lo * kb, hi * kb
        ctr_s = ctr_step[lo:hi] - rb_lo
        rows_s = rows[cl:ch]
        cols_s = cols[cl * e_b:ch * e_b]
        vals_s = vals[cl:ch]
        pad = uniform - (hi - lo)
        if pad:
            ctr_s = np.concatenate(
                [ctr_s, np.full(pad, ctr_s[-1], np.int32)])
            rows_s = np.concatenate(
                [rows_s, np.zeros((pad * kb, e_b), np.int32)])
            cols_s = np.concatenate(
                [cols_s, np.zeros(pad * kb * e_b, np.int32)])
            vals_s = np.concatenate(
                [vals_s, np.zeros((pad * kb, e_b), np.float32)])
        # ctr is sorted, so each stripe's steps are one contiguous run
        chunk_ptr = (np.searchsorted(ctr_s, np.arange(rb_hi - rb_lo + 1))
                     * kb).astype(np.int32)
        segments.append(GScatterSegment(
            ctr=dev(ctr_s.astype(np.int32)), rows=dev(rows_s),
            cols=dev(cols_s), vals=dev(vals_s), chunk_ptr=dev(chunk_ptr),
            rb_lo=rb_lo, rb_hi=rb_hi,
            slot_lo=cl * e_b, slot_hi=ch * e_b,
        ))
    gs = GScatter(segments=tuple(segments), tile=tile, e_b=e_b, kb=kb,
                  n_rows=n, n_cols=m)
    if not return_slots:
        return gs
    slots_in = np.empty(len(order), np.int64)
    slots_in[order] = slot
    return gs, slots_in


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as the kernel reads it: f32 for "highest", bf16 for "default"."""
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    xk = x.to(torch.float32)
    return xk if precision == "highest" else xk.to(torch.bfloat16)


def build_schedule(chunk_ptr, budget: int):
    """The kernel's work items over one segment's chunks (numpy only).

    Whole stripes are packed into one item while its chunks stay within
    ``budget``; a stripe of more chunks is cut into ``ceil(n / budget)``
    near-equal items of its own. Returns ``(item_ptr, item_stripe)``, both
    int32: item ``i`` walks chunks ``item_ptr[i]:item_ptr[i + 1]``, the
    first of them in stripe ``item_stripe[i]``. The items cover every chunk
    once, in order, so every stripe (each holds at least one chunk) is
    reached.
    """
    ptr = np.asarray(chunk_ptr, np.int64)
    budget = max(1, int(budget))
    starts, stripes = [], []
    open_lo = None  # first chunk of the item that packs small stripes
    for s in range(len(ptr) - 1):
        lo, hi = int(ptr[s]), int(ptr[s + 1])
        if open_lo is not None and hi - open_lo > budget:
            open_lo = None
        if hi - lo > budget:
            k = -(-(hi - lo) // budget)
            starts.extend(lo + (np.arange(k) * (hi - lo)) // k)
            stripes.extend([s] * k)
        elif open_lo is None:
            open_lo = lo
            starts.append(lo)
            stripes.append(s)
    item_ptr = np.append(np.asarray(starts, np.int64), ptr[-1])
    return item_ptr.astype(np.int32), np.asarray(stripes, np.int32)


def _chunk_budget(gs: GScatter, seg: GScatterSegment, n_ftiles: int,
                  device) -> int:
    """Chunks one work item walks: :data:`_SLOTS_PER_ITEM` worth, or fewer
    where that would leave under :data:`_MIN_BLOCKS_PER_SM` thread blocks
    per SM (one block per item and feature tile)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    items = -(-_MIN_BLOCKS_PER_SM * sms // n_ftiles)
    per_item = max(1, _SLOTS_PER_ITEM // gs.e_b)
    return max(1, min(per_item, -(-int(seg.rows.shape[0]) // items)))


def work_items(gs: GScatter, f: int, device, width: Optional[int] = None):
    """What the kernel launches for x of ``f`` features on ``device``:
    ``(width, launches)``, ``width`` the features of one thread block and
    ``launches`` one ``(level, segment, item_ptr, item_stripe)`` per
    segment of every level. Each segment's items are built once and kept
    beside its tables."""
    w = feat_width(gs.tile, f, FEAT_WIDTH if width is None else width)
    n_ftiles = -(-f // w)
    launches = []
    for level in (gs,) + gs.overflow:
        for seg in level.segments:
            budget = _chunk_budget(level, seg, n_ftiles, device)
            if budget not in seg.schedules:
                item_ptr, item_stripe = build_schedule(
                    seg.chunk_ptr.cpu().numpy(), budget)
                dev = seg.chunk_ptr.device
                seg.schedules[budget] = (torch.from_numpy(item_ptr).to(dev),
                                         torch.from_numpy(item_stripe).to(dev))
            launches.append((level, seg) + seg.schedules[budget])
    return w, launches


def feat_width(tile: int, f: int, widest: int = FEAT_WIDTH) -> int:
    """The features one thread block takes: the least of 32, 64 and 128
    that covers ``f``, at most ``widest``, and narrower where ``tile``
    rows of it would not fit in shared memory."""
    w = 32
    while w < min(f, widest):
        w *= 2
    while w > 32 and tile * w * 4 > _MAX_SHARED:
        w //= 2
    return w


def gscatter_spmm_plain(gs: GScatter, x: torch.Tensor, *,
                        precision: str = "highest") -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` over the same tables.
    "default" reads x in bf16 and rounds each weighted product to bf16
    before the f32 sum, where the JAX kernel rounds it.

    Runs on any device; the reference the kernel is held against.
    """
    xk = _operand(x, precision).to(torch.float32)
    f = xk.shape[1]
    n_pad = (-(-gs.n_rows // gs.tile)) * gs.tile
    out = torch.zeros(n_pad, f, dtype=torch.float32, device=xk.device)
    for seg in gs.segments:
        stripe = seg.ctr.to(torch.int64).repeat_interleave(gs.kb) + seg.rb_lo
        dest = (stripe[:, None] * gs.tile + seg.rows).reshape(-1)
        contrib = xk[seg.cols.to(torch.int64)] * seg.vals.reshape(-1, 1)
        if precision == "default":
            contrib = contrib.to(torch.bfloat16).to(torch.float32)
        out.index_add_(0, dest, contrib)
    out = out[:gs.n_rows]
    for ov in gs.overflow:
        out = out + gscatter_spmm_plain(ov, x, precision=precision)
    return out


def gscatter_spmm(gs: GScatter, x: torch.Tensor, *,
                  precision: str = "highest",
                  width: Optional[int] = None) -> torch.Tensor:
    """``A @ x`` for a :class:`GScatter`: ``x`` [m, F] -> [n, F] float32.

    A CPU tensor takes :func:`gscatter_spmm_plain`; a CUDA tensor launches
    the kernel (one launch per segment and overflow level, into one zeroed
    output) or raises. ``width`` caps the features of one thread block
    (default :data:`FEAT_WIDTH`).
    """
    if x.device.type == "cpu":
        return gscatter_spmm_plain(gs, x, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"gscatter_spmm: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] != gs.n_cols:
        raise ValueError(f"gscatter_spmm: x {tuple(x.shape)} does not match "
                         f"A [{gs.n_rows}, {gs.n_cols}]")
    if gs.tile > _MAX_TILE:
        raise ValueError(f"gscatter_spmm: tile {gs.tile} > {_MAX_TILE} does "
                         "not fit the kernel's shared stripe")
    xk = _operand(x, precision).contiguous()
    f = xk.shape[1]
    out = torch.zeros(gs.n_rows, f, dtype=torch.float32, device=xk.device)
    if f == 0 or gs.n_rows == 0:
        return out
    w, launches = work_items(gs, f, xk.device, width)
    lib, _ = _build.library()
    stream = torch.cuda.current_stream(xk.device).cuda_stream
    for level, seg, item_ptr, item_stripe in launches:
        for t, dt in ((seg.chunk_ptr, torch.int32), (seg.rows, torch.int32),
                      (seg.cols, torch.int32), (seg.vals, torch.float32)):
            if t.device != xk.device or not t.is_contiguous() or t.dtype != dt:
                raise ValueError("gscatter_spmm: tables must be contiguous, "
                                 f"of build_gscatter's types and on "
                                 f"{xk.device}")
        err = lib.h2gcn_gscatter_spmm(
            item_ptr.data_ptr(), item_stripe.data_ptr(),
            int(item_stripe.shape[0]), seg.chunk_ptr.data_ptr(),
            seg.rows.data_ptr(), seg.cols.data_ptr(), seg.vals.data_ptr(),
            xk.data_ptr(), int(xk.dtype == torch.bfloat16), out.data_ptr(),
            seg.rb_lo, level.tile, level.e_b, level.n_rows, f, w, stream)
        _build.check(lib, err, "gscatter_spmm")
        gscatter_spmm.launches += 1
    return out


gscatter_spmm.launches = 0  # kernel launches; chip_smoke.py reads it

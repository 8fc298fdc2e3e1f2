"""Gather-scatter SpMM for the ultra-sparse regime: the CUDA kernel's
row-major payload, its wrapper and plain version, and the JAX package's
chunk tables.

:func:`gscatter_spmm` launches ``csrc/gscatter.cu`` (#1) over a
:class:`RowMajor` payload: the matrix's entries in row-major order (a
canonical CSR's column indices and values, read where the caller keeps
them), its row pointer, and the work items that :func:`row_schedule` cuts
from it once, at set-up. A CPU tensor takes :func:`gscatter_rows_plain`,
which sums over the same items; a CUDA tensor launches the kernel, once a
call, or raises.

The chunk tables (:func:`build_gscatter_coo`) are those of
``h2gcn_tpu/sparse/pallas_gscatter.py``, built the same way so the two
packages can be compared table for table: edges are grouped by 512-row
destination stripe, sorted by source column inside each stripe, cut into
``e_b``-slot chunks, and each stripe's chunk list is padded to a multiple
of ``kb`` (one TPU grid step) with at least one step per stripe, so every
output row is written. Segments cap the steps per launch, and a stripe with
more than ``max_steps`` steps (a mega-hub) spills into overflow levels
whose outputs are summed. :func:`gscatter_spmm_plain` reduces over them;
the GAT gather payload (``attention_gather.py``) and its kernel
(``csrc/gscatter_weighted.cu``, #10) walk them with :func:`build_schedule`'s
work items.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from . import _build

_KB = 8          # chunks per step (a TPU grid step; kept for table parity)
_MAX_STEPS = 2048  # steps per segment
# a shared stripe of tile x width f32, width the features of one thread
# block (32, 64 or 128): at most the 227 KB a block can have
_MAX_SHARED = 232448
# the widest feature tile a chunk-table kernel takes where the stripe still
# fits
FEAT_WIDTH = 128
# table slots one work item of the chunk tables walks at most (chunks =
# this // e_b): its flush of up to tile x width outputs stays small beside
# its edges' gathers
_SLOTS_PER_ITEM = 16384
# ...but a small segment gets smaller items, so that the grid still holds
# this many thread blocks per SM
_MIN_BLOCKS_PER_SM = 4

# #1's work items: about this many per SM, so that the last wave of groups
# is short beside the call, but no fewer entries than 1.5 mean rows, so
# that a typical row stays whole in one item...
_ITEMS_PER_SM = 256
# ...each summing between these many entries: the least so that an item's
# fixed work (its table reads) stays small beside its gathers, the most
# the fastest at arXiv-year's and the 10K graph's Â₂ on the H100 (PERF.md,
# section 6)
_MIN_ITEM_ENTRIES = 32
MAX_ITEM_ENTRIES = 256
# streaming multiprocessors the items are cut for off the card (the H100's)
_SMS = 132


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
    """A chunk-table kernel's work items over one segment's chunks (numpy
    only; #10's, ``csrc/gscatter_weighted.cu``).

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


def chunk_budget(n_chunks: int, e_b: int, sms: int, n_ftiles: int = 1) -> int:
    """Chunks one work item walks: :data:`_SLOTS_PER_ITEM` worth, or fewer
    where that would leave under :data:`_MIN_BLOCKS_PER_SM` thread blocks
    on each of ``sms`` SMs (one block per item and feature tile)."""
    items = -(-_MIN_BLOCKS_PER_SM * sms // n_ftiles)
    per_item = max(1, _SLOTS_PER_ITEM // e_b)
    return max(1, min(per_item, -(-n_chunks // items)))


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
    """``A @ x`` over the chunk tables: ``index_add_`` over every slot.
    "default" reads x in bf16 and rounds each weighted product to bf16
    before the f32 sum, where the JAX kernel rounds it.

    Runs on any device; held against the JAX package's kernel.
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


@dataclasses.dataclass
class RowMajor:
    """#1's payload: a matrix's entries in row-major order and the work
    items over them (:func:`row_schedule`), built once at set-up.

    ``cols`` and ``vals`` may be longer than ``nnz`` (a caller's padded
    arrays); the kernel reads the first ``nnz``. ``items[i]`` is item
    ``i``'s ``(first entry, first row, split of its first row, split of its
    last row)``, a split -1 where that row is whole in the item; the extra
    last row holds ``(nnz, n_rows, -1, -1)``. ``splits[s]`` is split row
    ``s``'s ``(first slot, first item)``: its pieces, one an item, take
    consecutive slots of the call's scratch, and the extra last row holds
    ``(slots, items)``. ``counters`` keeps, by feature tiles, the kernel's
    count of pieces summed for each split row, zero between calls."""

    row_ptr: torch.Tensor   # [n_rows + 1] int32
    cols: torch.Tensor      # [>= nnz] int32, ascending inside a row
    vals: torch.Tensor      # [>= nnz] float32
    items: torch.Tensor     # [n_items + 1, 4] int32
    splits: torch.Tensor    # [n_split + 1, 2] int32
    n_cols: int
    nnz: int
    n_slots: int
    counters: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_items(self) -> int:
        return self.items.shape[0] - 1

    @property
    def n_split(self) -> int:
        return self.splits.shape[0] - 1


def item_budget(nnz: int, n_rows: int, sms: int) -> int:
    """Entries one work item of #1 sums: enough items for
    :data:`_ITEMS_PER_SM` on each of ``sms`` SMs, or 1.5 mean rows where
    that is more, within :data:`_MIN_ITEM_ENTRIES` to
    :data:`MAX_ITEM_ENTRIES`."""
    per_item = -(-nnz // (_ITEMS_PER_SM * sms))
    rows = -(-3 * nnz // (2 * max(1, n_rows)))
    return int(min(MAX_ITEM_ENTRIES, max(_MIN_ITEM_ENTRIES, per_item, rows)))


def row_schedule(row_ptr, budget: int):
    """#1's work items over a row pointer (numpy only): ``(items,
    splits)`` as :class:`RowMajor` holds them.

    The entries are cut every ``budget``; a cut inside a row of at most
    ``budget`` entries moves to the nearer end of that row, so only a
    longer row is split, into one piece an item it meets. Each row is
    written by the item where it ends (an empty row: where its position
    falls; rows past the last entry: the last item), so every row is
    written once.
    """
    ptr = np.asarray(row_ptr, np.int64)
    n, nnz = len(ptr) - 1, int(ptr[-1])
    if nnz >= 2 ** 31:
        raise ValueError(f"gscatter: {nnz} entries do not fit int32 offsets")
    budget = max(1, int(budget))
    cuts = np.arange(budget, nnz, budget, dtype=np.int64)
    r = np.searchsorted(ptr, cuts, side="right") - 1
    start, end = ptr[r], ptr[r + 1]
    nearer = np.where(end - cuts < cuts - start, end, start)
    cuts = np.where(end - start <= budget, nearer, cuts)
    bounds = np.unique(np.concatenate([[0], cuts, [nnz]]))
    if len(bounds) == 1:  # no entries: one item writes every row
        bounds = np.zeros(2, np.int64)
    n_items = len(bounds) - 1
    # rows [first[i], first[i + 1]) end in item i; row first[i + 1] may
    # begin there too
    first = np.searchsorted(ptr[1:], bounds, side="right")
    first[0], first[-1] = 0, n
    inner = bounds[1:-1]
    r = np.searchsorted(ptr, inner, side="right") - 1
    split_rows = np.unique(r[ptr[r] < inner])
    tracing.count("gscatter.split_rows", int(split_rows.size))
    # split row s lies in items a[s]..b[s], one piece each
    a = np.searchsorted(bounds, ptr[split_rows], side="right") - 1
    b = np.searchsorted(bounds, ptr[split_rows + 1], side="left") - 1
    pieces = b - a + 1
    slot0 = np.concatenate([[0], np.cumsum(pieces)])
    lo_split = np.full(n_items + 1, -1, np.int64)
    hi_split = np.full(n_items + 1, -1, np.int64)
    sid = np.repeat(np.arange(split_rows.size), pieces - 1)
    step = np.arange(sid.size) - np.repeat(slot0[:-1] - np.arange(
        split_rows.size), pieces - 1)
    lo_split[a[sid] + 1 + step] = sid  # items a+1..b: the row began before
    hi_split[a[sid] + step] = sid      # items a..b-1: it goes on past
    items = np.stack([bounds, first, lo_split, hi_split], axis=1)
    splits = np.stack([slot0, np.append(a, n_items)], axis=1)
    return items.astype(np.int32), splits.astype(np.int32)


def build_row_major(row_ptr, cols: torch.Tensor, vals: torch.Tensor,
                    n_cols: int, *, budget: Optional[int] = None) -> RowMajor:
    """#1's payload over a canonical CSR's ``row_ptr`` (numpy) and its
    ``cols`` and ``vals``, kept as they are, on their device. ``budget``
    defaults to :func:`item_budget` for that device's SMs."""
    device = cols.device
    ptr = np.asarray(row_ptr, np.int64)
    if budget is None:
        sms = (torch.cuda.get_device_properties(device).multi_processor_count
               if device.type == "cuda" else _SMS)
        budget = item_budget(int(ptr[-1]), len(ptr) - 1, sms)
    if cols.dtype != torch.int32 or vals.dtype != torch.float32:
        raise ValueError("gscatter: cols must be int32 and vals float32")
    if vals.device != device:
        raise ValueError("gscatter: cols and vals must be on one device")
    if cols.shape[0] < ptr[-1] or vals.shape[0] < ptr[-1]:
        raise ValueError("gscatter: fewer cols or vals than row_ptr counts")
    items, splits = row_schedule(ptr, budget)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # the counters of one feature tile (F up to 128) exist before any call,
    # so that a call captured in a CUDA graph allocates none
    counters = {1: torch.zeros(max(1, len(splits) - 1), dtype=torch.int32,
                               device=device)}
    return RowMajor(row_ptr=dev(ptr.astype(np.int32)),
                    cols=cols.contiguous(), vals=vals.contiguous(),
                    items=dev(items), splits=dev(splits), n_cols=int(n_cols),
                    nnz=int(ptr[-1]), n_slots=int(splits[-1, 0]),
                    counters=counters)


def _pieces(rm: RowMajor):
    """Each entry's destination as #1 sums it, on the payload's device:
    its row, or ``n_rows`` + the slot of its piece where the item that
    holds it has only a piece of its row; and each slot's row."""
    ptr = rm.row_ptr.long()
    items, splits = rm.items.long(), rm.splits.long()
    n, dev = rm.n_rows, ptr.device
    row = torch.repeat_interleave(torch.arange(n, device=dev), ptr.diff())
    item = torch.repeat_interleave(torch.arange(rm.n_items, device=dev),
                                   items[:, 0].diff())
    began = ptr[row] < items[item, 0]
    goes_on = ptr[row + 1] > items[item + 1, 0]
    piece = began | goes_on
    s = torch.where(began, items[item, 2], items[item, 3])[piece]
    dest = row.clone()
    dest[piece] = n + splits[s, 0] + item[piece] - splits[s, 1]
    # a split row's first piece is the last row of its first item; each
    # later piece the first row of its item
    slot_split = torch.repeat_interleave(
        torch.arange(rm.n_split, device=dev), splits[:, 0].diff())
    slot_item = (splits[slot_split, 1] + torch.arange(rm.n_slots, device=dev)
                 - splits[slot_split, 0])
    is_first = slot_item == splits[slot_split, 1]
    slot_row = torch.where(is_first, items[slot_item + 1, 1],
                           items[slot_item, 1])
    return dest, slot_row


def gscatter_rows_plain(rm: RowMajor, x: torch.Tensor, *,
                        precision: str = "highest") -> torch.Tensor:
    """``A @ x`` over #1's payload as the kernel sums it: each entry's
    product (rounded to bf16 in "default", after a bf16 read of x) added
    in f32, in entry order, into its row or its piece, then each split
    row's pieces added in slot order.

    Runs on any device; the reference the kernel is held against.
    """
    xk = _operand(x, precision).to(torch.float32)
    nnz = rm.nnz
    prod = xk[rm.cols[:nnz].long()] * rm.vals[:nnz, None]
    if precision == "default":
        prod = prod.to(torch.bfloat16).to(torch.float32)
    dest, slot_row = _pieces(rm)
    acc = torch.zeros(rm.n_rows + rm.n_slots, xk.shape[1],
                      dtype=torch.float32, device=xk.device)
    acc.index_add_(0, dest, prod)
    out = acc[:rm.n_rows]
    return out.index_add_(0, slot_row, acc[rm.n_rows:])


def gscatter_spmm(rm: RowMajor, x: torch.Tensor, *,
                  precision: str = "highest") -> torch.Tensor:
    """``A @ x`` over #1's payload: ``x`` [m, F] -> [n, F] float32.

    A CPU tensor takes :func:`gscatter_rows_plain`; a CUDA tensor launches
    the kernel once, writing every output row, or raises.
    """
    if x.device.type == "cpu":
        return gscatter_rows_plain(rm, x, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"gscatter_spmm: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] != rm.n_cols:
        raise ValueError(f"gscatter_spmm: x {tuple(x.shape)} does not match "
                         f"A [{rm.n_rows}, {rm.n_cols}]")
    if rm.items.device != x.device:
        raise ValueError(f"gscatter_spmm: the payload is on "
                         f"{rm.items.device}, x on {x.device}")
    xk = _operand(x, precision).contiguous()
    f = xk.shape[1]
    out = torch.empty(rm.n_rows, f, dtype=torch.float32, device=xk.device)
    if f == 0 or rm.n_rows == 0:
        return out
    # the kernel's feature tiles: a group of up to 32 lanes, 4 features a
    # lane, takes 128; a narrower F takes one
    n_ftiles = -(-f // 128)
    counters = rm.counters.get(n_ftiles)
    if counters is None:
        counters = rm.counters[n_ftiles] = torch.zeros(
            max(1, rm.n_split * n_ftiles), dtype=torch.int32,
            device=xk.device)
    part = torch.empty(max(1, rm.n_slots), f, dtype=torch.float32,
                       device=xk.device)
    lib, _ = _build.library()
    err = lib.h2gcn_gscatter_spmm(
        rm.items.data_ptr(), rm.splits.data_ptr(), rm.row_ptr.data_ptr(),
        rm.cols.data_ptr(), rm.vals.data_ptr(), xk.data_ptr(),
        int(xk.dtype == torch.bfloat16), out.data_ptr(), part.data_ptr(),
        counters.data_ptr(), rm.n_items, rm.n_rows, f,
        torch.cuda.current_stream(xk.device).cuda_stream)
    _build.check(lib, err, "gscatter_spmm")
    tracing.launched("gscatter_spmm")
    return out

"""Per-row (or per-column) edge lists and the work items that the attention
kernels walk over them.

The forward and row pass walk each destination row's sources
(``csrc/gat_attention_coo.cu``); the column pass walks each source column's
destinations (``csrc/gat_attention_col.cu``); all three for the COO-chunk
payload (:mod:`.attention_coo`) and for the BSR mask (:mod:`.attention`).
One warp takes one work item (:func:`build_edge_items`): a run of whole
rows within a budget of edges, or a piece of a longer row, whose partial
state a second small launch merges (``csrc/gat_items.cuh``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import tracing
from . import _build

# Edges one item (one warp) walks at most, items a thread block, and what a
# row costs an item beside its edges, in edges (a warp walks its rows one
# after another, each a chain of dependent loads); from chip_smoke.py's
# coo_sweep on the H100 (PERF.md)
EDGE_BUDGET = 128
ITEM_WARPS = 4
ROW_COST = 16
_MAX_ITEM_WARPS = 16  # csrc/gat_items.cuh kMaxItemWarps
_MAX_ITEM_ROWS = 32   # rows one item walks at most (the kernels' limit)


@dataclasses.dataclass
class EdgeItems:
    """The work items over per-row (``kind="fwd"``) or per-column
    (``"col"``) lists: each item is one warp's walk. ``items[i] = (lo, hi,
    e_lo, e_hi)``: rows ``lo .. hi``, clipped to list positions ``e_lo ..
    e_hi``; either a run of whole rows or one piece of a split row, whose
    partial state goes to workspace slot ``slot[i]`` (-1 for whole rows).
    Split row ``split_rows[s]`` has slots ``split_ptr[s] .. split_ptr[s +
    1]``."""

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


def cached_items(cache: dict, ptr: torch.Tensor, kind: str,
                 budget: Optional[int] = None,
                 row_cost: Optional[int] = None) -> EdgeItems:
    """The work items over the lists ``ptr`` at ``budget`` edges an item
    and ``row_cost`` (:data:`EDGE_BUDGET` and :data:`ROW_COST` by default),
    built once and kept in ``cache`` under ``(kind, budget, row_cost)``, on
    ``ptr``'s device."""
    budget = EDGE_BUDGET if budget is None else int(budget)
    row_cost = ROW_COST if row_cost is None else int(row_cost)
    key = (kind, budget, row_cost)
    if key not in cache:
        parts = build_edge_items(ptr.cpu().numpy(), budget, row_cost)
        cache[key] = EdgeItems(
            *(torch.from_numpy(a).to(ptr.device) for a in parts),
            kind=kind, budget=budget, row_cost=row_cost,
            n_pieces=int(parts[3][-1]))
    return cache[key]


def launch_items(wrapper, fn: str, ptr, other, it: EdgeItems, tensors,
                 ws_floats: int, *, num_heads: int, feat: int, slope: float,
                 precision: str, warps: Optional[int]) -> None:
    """Launch the item kernel ``fn`` over the lists ``(ptr, other)`` and
    their items ``it`` with ``warps`` items a block (:data:`ITEM_WARPS` by
    default) on ``tensors`` (data pointers, in the launcher's order) and a
    workspace of ``ws_floats`` a split row's piece; raises on a launch
    error and counts the launch under ``launches.<wrapper name>`` (its
    merge launch, when a row is split, is part of it)."""
    name = wrapper.__name__
    warps = ITEM_WARPS if warps is None else int(warps)
    if not 1 <= warps <= _MAX_ITEM_WARPS:
        raise ValueError(f"{name}: warps {warps} is outside "
                         f"1..{_MAX_ITEM_WARPS}")
    ref = tensors[0]
    for t in (ptr, other, it.items, it.slot, it.split_rows, it.split_ptr):
        if t.device != ref.device or t.dtype != torch.int32:
            raise ValueError(f"{name}: the lists and items must be int32 on "
                             f"{ref.device}")
    ws = (torch.empty(it.n_pieces * ws_floats, dtype=torch.float32,
                      device=ref.device) if it.n_pieces else None)
    lib, _ = _build.library()
    err = getattr(lib, fn)(
        it.items.data_ptr(), it.slot.data_ptr(), it.split_rows.data_ptr(),
        it.split_ptr.data_ptr(), ptr.data_ptr(), other.data_ptr(),
        *(t.data_ptr() for t in tensors),
        None if ws is None else ws.data_ptr(), it.n_items, it.n_split,
        num_heads, feat, slope, int(precision == "default"), warps,
        torch.cuda.current_stream(ref.device).cuda_stream)
    _build.check(lib, err, name)
    tracing.launched(name)

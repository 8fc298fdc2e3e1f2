"""COO-tile SpMM: edges chunked per ``T x T`` tile. Host tables, the CUDA
kernel's wrapper, and its plain PyTorch version.

The tables are those of ``h2gcn_tpu/sparse/pallas_cootile.py``, built the
same way so the two packages can be compared table for table: edges are
sorted by (tile row, tile column), cut into ``e_b``-slot chunks (one tile
pair per chunk), every tile row gets at least one chunk (a zero filler), and
each tile row's chunk list is padded to a multiple of ``kb`` with
zero-valued fillers. The fused COO-chunk attention (:mod:`.attention_coo`)
reads them too.

:class:`CooTile` holds one table set on the device (the JAX package's SMEM
segments are a TPU workaround and are not ported) plus each tile row's first
chunk. :func:`cootile_spmm` launches ``csrc/cootile_spmm.cu`` on a CUDA
tensor and takes :func:`cootile_spmm_plain` only for a CPU tensor. The JAX
package's v5e geometry model (``auto_geometry``) is not ported: ``tile``
defaults to :data:`DEFAULT_TILE`, measured on the H100, and ``kb`` to 1
(its padding only serves the TPU grid).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from . import _build
from .gscatter import _MAX_SHARED, _operand, feat_width

KB = 8  # chunks per step of the JAX package's grid; kept for table parity
# build_cootile's tile when none is given, and the widest feature tile of
# one thread block: the fastest of tile 128 and 256 x 64 and 128 features
# at the 10K-node A2 (F = 128) and the cluster-ordered 250K-node A2
# (F = 64 and 128) on the H100 (PERF.md, section 6)
DEFAULT_TILE = 256
FEAT_WIDTH = 128
# the kernel's shared accumulator is tile x width f32, width at least 32
_MAX_TILE = _MAX_SHARED // (32 * 4)
# The kernel's schedule, in two regimes (the H100 sweep in PERF.md,
# section 6): the table slots a thread block walks (chunks_per_block = this
# // e_b) and the 32-slot groups a warp walks before the next warp's (0: one
# contiguous piece of a tile row's slots a warp). Where x fits in half the
# L2 or the tables are mostly padding, a warp takes one piece and a block
# 16,384 slots; where x is past half the L2 over tables at least 10% full,
# a block's warps walk pieces of 4 groups round-robin, so they gather rows
# of neighbouring tile columns at once, over ranges of 65,536 slots (a
# quarter of the global flushes).
_SLOTS_PER_BLOCK = 16384
_SLOTS_PER_BLOCK_PAST_L2 = 65536
_PIECE_PAST_L2 = 4
_MIN_FILL_PAST_L2 = 0.1
# ...but a small matrix gets smaller ranges, so that the grid still holds
# this many thread blocks per SM
_MIN_BLOCKS_PER_SM = 4
# slots the plain version gathers at once (bounds its [slots, F] buffer)
_PLAIN_SLOTS = 1 << 22


def _padded_chunk_count(row_of_tile, counts, n_rb, e_b, kb=KB) -> int:
    """Chunks :func:`build_chunk_tables` emits: per-tile ceil division,
    every tile row padded to a multiple of ``kb`` (empty rows get one full
    filler block)."""
    per_row = np.bincount(row_of_tile, weights=-(-counts // e_b),
                          minlength=n_rb)
    per_row = np.where(per_row == 0, kb, -(-per_row // kb) * kb)
    return int(per_row.sum())


def _auto_e_b(coo, tile: int, ncb: int) -> int:
    """Chunk size from mean edges per visited tile (<= 50% padding)."""
    if coo.nnz == 0:
        return 128
    n_tiles = np.unique((coo.row // tile).astype(np.int64) * ncb
                        + coo.col // tile).size
    mean = coo.nnz / max(n_tiles, 1)
    for cand in (128, 256):
        if mean <= cand * 1.5:
            return cand
    return 512


def build_chunk_tables(csr, tile: int = 512, e_b: int | None = 512,
                       kb: int = KB):
    """Chunk tables of a scipy matrix (numpy only).

    ``e_b=None`` sizes the chunk from the graph's mean edges per visited
    tile (:func:`_auto_e_b`). Returns ``(ctr, ctc, rows, cols, vals, n_rb,
    e_b)``: per chunk its tile row ``ctr`` and tile column ``ctc`` (int32,
    ``ctr`` ascending), and per slot the tile-local row and column (int32)
    and the value (float32, 0 in padding slots), each ``[nchunks, e_b]``.
    """
    import scipy.sparse as sp

    csr = sp.csr_matrix(csr)
    coo = csr.tocoo()
    n, m = csr.shape
    n_rb = -(-n // tile)
    ncb = -(-m // tile)
    if e_b is None:
        e_b = _auto_e_b(coo, tile, ncb)

    # one flat (tile row, tile column) key; the order of edges inside a
    # tile does not matter to the consumers
    key = ((coo.row // tile).astype(np.int64) * ncb + coo.col // tile)
    order = np.argsort(key, kind="stable")
    r = coo.row[order].astype(np.int64)
    c = coo.col[order].astype(np.int64)
    v = coo.data[order].astype(np.float32)
    tile_key = key[order]

    uniq, starts, counts = np.unique(tile_key, return_index=True,
                                     return_counts=True)
    chunks_per_tile = -(-counts // e_b)
    chunk_offset = np.concatenate([[0], np.cumsum(chunks_per_tile)])
    nchunks = int(chunk_offset[-1])

    if nchunks:
        pos_in_tile = np.arange(len(r)) - np.repeat(starts, counts)
        chunk_id = np.repeat(chunk_offset[:-1], counts) + pos_in_tile // e_b
        slot = chunk_id * e_b + pos_in_tile % e_b
    else:
        slot = np.zeros(0, np.int64)

    ctr = np.repeat((uniq // ncb).astype(np.int32), chunks_per_tile)
    ctc = np.repeat((uniq % ncb).astype(np.int32), chunks_per_tile)
    # filler chunks: every tile row gets at least one chunk
    missing = np.setdiff1d(np.arange(n_rb, dtype=np.int32), ctr)
    total = nchunks + len(missing)
    rows = np.zeros(total * e_b, np.int32)
    cols = np.zeros(total * e_b, np.int32)
    vals = np.zeros(total * e_b, np.float32)
    rows[slot] = r % tile
    cols[slot] = c % tile
    vals[slot] = v
    ctr = np.concatenate([ctr, missing])
    ctc = np.concatenate([ctc, np.zeros(len(missing), np.int32)])
    order2 = np.argsort(ctr, kind="stable")
    ctr, ctc = ctr[order2], ctc[order2]
    rows = rows.reshape(total, e_b)[order2]
    cols = cols.reshape(total, e_b)[order2]
    vals = vals.reshape(total, e_b)[order2]

    # every tile row's chunk list padded to a multiple of kb; the fillers
    # carry vals = 0 and repeat the row's last tile column
    counts_r = np.bincount(ctr, minlength=n_rb)  # >= 1 per row (fillers)
    pad_r = (-counts_r) % kb
    if pad_r.any():
        last = np.cumsum(counts_r) - 1           # each row's last chunk
        fill_ctr = np.repeat(np.arange(n_rb, dtype=np.int32), pad_r)
        fill_ctc = ctc[last][fill_ctr]
        npad = len(fill_ctr)
        ctr = np.concatenate([ctr, fill_ctr])
        ctc = np.concatenate([ctc, fill_ctc])
        rows = np.concatenate([rows, np.zeros((npad, e_b), np.int32)])
        cols = np.concatenate([cols, np.zeros((npad, e_b), np.int32)])
        vals = np.concatenate([vals, np.zeros((npad, e_b), np.float32)])
        order3 = np.argsort(ctr, kind="stable")
        ctr, ctc = ctr[order3], ctc[order3]
        rows, cols, vals = rows[order3], cols[order3], vals[order3]
    return ctr, ctc, rows, cols, vals, n_rb, e_b


@dataclasses.dataclass
class CooTile:
    """One COO-tile table set on a device. Chunks are sorted by tile row;
    tile row ``r`` owns chunks ``row_ptr[r]:row_ptr[r + 1]`` (at least one)."""

    ctr: torch.Tensor      # [nchunks] int32 tile row of each chunk
    ctc: torch.Tensor      # [nchunks] int32 tile column of each chunk
    rows: torch.Tensor     # [nchunks, e_b] int32 tile-local destination rows
    cols: torch.Tensor     # [nchunks, e_b] int32 tile-local source columns
    vals: torch.Tensor     # [nchunks, e_b] float32 (0 marks padding slots)
    row_ptr: torch.Tensor  # [n_rb + 1] int32 first chunk of each tile row
    tile: int
    e_b: int
    kb: int
    n_rows: int
    n_cols: int
    nnz: int = 0           # live slots

    @property
    def num_chunks(self) -> int:
        return int(self.ctr.shape[0])

    def heaviest_row_chunks(self) -> int:
        """Chunks of the tile row that holds the most."""
        return int(torch.diff(self.row_ptr).max())


def build_cootile(csr, tile: int | None = None, e_b: int | None = None,
                  kb: int = 1, device="cpu") -> CooTile:
    """The chunk tables of a scipy matrix (:func:`build_chunk_tables`) on
    ``device``. ``tile=None`` takes :data:`DEFAULT_TILE`; ``e_b=None``
    sizes the chunk from the matrix's mean edges per visited tile."""
    tile = DEFAULT_TILE if tile is None else int(tile)
    n, m = csr.shape
    ctr, ctc, rows, cols, vals, n_rb, e_b = build_chunk_tables(
        csr, tile=tile, e_b=e_b, kb=kb)
    row_ptr = np.searchsorted(ctr, np.arange(n_rb + 1)).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return CooTile(ctr=dev(ctr), ctc=dev(ctc), rows=dev(rows),
                   cols=dev(cols), vals=dev(vals), row_ptr=dev(row_ptr),
                   tile=tile, e_b=int(e_b), kb=int(kb), n_rows=int(n),
                   n_cols=int(m), nnz=int(np.count_nonzero(vals)))


def _chunks_per_block(ct: CooTile, f: int, width: int, sms: int,
                      range_slots: int = _SLOTS_PER_BLOCK) -> int:
    """Chunks one thread block walks: ``range_slots`` worth, or fewer where
    that would leave under :data:`_MIN_BLOCKS_PER_SM` blocks on each of
    ``sms`` SMs (one block per range and feature tile of ``width``; at the
    widths H2GCN aggregates, one tile covers F)."""
    per_range = max(1, range_slots // ct.e_b)
    ranges = -(-_MIN_BLOCKS_PER_SM * sms // -(-f // width))
    return max(1, min(per_range, -(-ct.num_chunks // ranges)))


def schedule(ct: CooTile, x_bytes: int, l2_bytes: int):
    """``(piece, range_slots)`` of the kernel's two regimes (see
    :data:`_SLOTS_PER_BLOCK`) for x of ``x_bytes`` on a card with
    ``l2_bytes`` of L2."""
    fill = ct.nnz / max(1, ct.num_chunks * ct.e_b)
    if 2 * x_bytes > l2_bytes and fill >= _MIN_FILL_PAST_L2:
        return _PIECE_PAST_L2, _SLOTS_PER_BLOCK_PAST_L2
    return 0, _SLOTS_PER_BLOCK


def work_shape(ct: CooTile, f: int, device, width: int | None = None,
               range_slots: int | None = None, piece: int | None = None,
               x_bytes: int | None = None):
    """What the kernel launches for x of ``f`` features (``x_bytes``,
    default f32) on ``device``: ``(width, chunks_per_block, ranges,
    piece)``, ``width`` the features of one thread block (at most
    ``width``, default :data:`FEAT_WIDTH`, and narrower where ``tile`` rows
    of it would not fit in shared memory); ``range_slots`` and ``piece``
    default to :func:`schedule`'s."""
    w = feat_width(ct.tile, f, FEAT_WIDTH if width is None else width)
    props = torch.cuda.get_device_properties(device)
    auto_piece, auto_slots = schedule(
        ct, ct.n_cols * f * 4 if x_bytes is None else x_bytes,
        props.L2_cache_size)
    per_block = _chunks_per_block(
        ct, f, w, props.multi_processor_count,
        auto_slots if range_slots is None else range_slots)
    return (w, per_block, -(-ct.num_chunks // per_block),
            auto_piece if piece is None else int(piece))


def row_runs(ct: CooTile) -> int:
    """Runs of live slots of one destination row inside a chunk: the
    kernel's shared-memory adds a lane makes (one per run and feature),
    against one per live slot without the runs."""
    runs = 0
    step = max(1, _PLAIN_SLOTS // ct.e_b)
    for c0 in range(0, ct.num_chunks, step):
        rows = ct.rows[c0:c0 + step].cpu().numpy()
        live = ct.vals[c0:c0 + step].cpu().numpy() != 0
        # a live slot opens a run unless the chunk's previous live slot
        # has its row
        chunk = np.broadcast_to(np.arange(rows.shape[0])[:, None], rows.shape)
        r, ch = rows[live], chunk[live]
        runs += int(len(r) and 1 + np.count_nonzero(
            (r[1:] != r[:-1]) | (ch[1:] != ch[:-1])))
    return runs


def cootile_spmm_plain(ct: CooTile, x: torch.Tensor, *,
                       precision: str = "highest") -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` of ``vals * x[ctc * T +
    cols]`` into ``ctr * T + rows``, over the live slots a few million at a
    time. "default" reads x in bf16 and rounds each product to bf16 before
    the f32 sum, where the JAX kernel rounds it. Runs on any device; the
    reference the kernel is held against."""
    xk = _operand(x, precision).to(torch.float32)
    f = xk.shape[1]
    T = ct.tile
    n_pad = (ct.row_ptr.shape[0] - 1) * T
    out = torch.zeros(n_pad, f, dtype=torch.float32, device=xk.device)
    step = max(1, _PLAIN_SLOTS // ct.e_b)
    for c0 in range(0, ct.num_chunks, step):
        sl = slice(c0, c0 + step)
        v = ct.vals[sl].reshape(-1)
        live = v != 0
        dest = (ct.ctr[sl].to(torch.int64)[:, None] * T
                + ct.rows[sl]).reshape(-1)[live]
        src = (ct.ctc[sl].to(torch.int64)[:, None] * T
               + ct.cols[sl]).reshape(-1)[live]
        prod = xk[src] * v[live][:, None]
        if precision == "default":
            prod = prod.to(torch.bfloat16).to(torch.float32)
        out.index_add_(0, dest, prod)
    return out[:ct.n_rows]


def cootile_spmm(ct: CooTile, x: torch.Tensor, *,
                 precision: str = "highest", width: int | None = None,
                 range_slots: int | None = None,
                 piece: int | None = None) -> torch.Tensor:
    """``A @ x`` for a :class:`CooTile`: ``x`` [m, F] -> [n, F] float32.

    A CPU tensor takes :func:`cootile_spmm_plain`; a CUDA tensor launches
    the kernel (once) or raises. ``width`` caps the features of one thread
    block (default :data:`FEAT_WIDTH`); ``range_slots`` (the table slots a
    block walks) and ``piece`` (the 32-slot groups a warp walks before the
    next warp's; 0: one piece a warp) default to :func:`schedule`'s.
    """
    if x.device.type == "cpu":
        return cootile_spmm_plain(ct, x, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"cootile_spmm: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] != ct.n_cols:
        raise ValueError(f"cootile_spmm: x {tuple(x.shape)} does not match "
                         f"A [{ct.n_rows}, {ct.n_cols}]")
    if ct.tile > _MAX_TILE:
        raise ValueError(f"cootile_spmm: tile {ct.tile} > {_MAX_TILE} does "
                         "not fit the kernel's shared accumulator")
    if width not in (None, 32, 64, 128):
        raise ValueError(f"cootile_spmm: width {width} is not 32, 64 or 128")
    if ct.e_b < 32:
        raise ValueError(f"cootile_spmm: e_b {ct.e_b} < 32: the kernel's "
                         "32-slot groups touch at most two chunks")
    xk = _operand(x, precision).contiguous()
    for t, dt in ((ct.ctr, torch.int32), (ct.ctc, torch.int32),
                  (ct.row_ptr, torch.int32), (ct.rows, torch.int32),
                  (ct.cols, torch.int32), (ct.vals, torch.float32)):
        if t.device != xk.device or not t.is_contiguous() or t.dtype != dt:
            raise ValueError("cootile_spmm: tables must be contiguous, of "
                             f"build_cootile's types and on {xk.device}")
    f = xk.shape[1]
    out = torch.zeros(ct.n_rows, f, dtype=torch.float32, device=xk.device)
    if f == 0 or ct.n_rows == 0 or ct.num_chunks == 0:
        return out
    w, per_block, _, piece = work_shape(
        ct, f, xk.device, width, range_slots, piece,
        xk.numel() * xk.element_size())
    lib, _ = _build.library()
    err = lib.h2gcn_cootile_spmm(
        ct.ctr.data_ptr(), ct.ctc.data_ptr(), ct.row_ptr.data_ptr(),
        ct.rows.data_ptr(), ct.cols.data_ptr(), ct.vals.data_ptr(),
        xk.data_ptr(), int(xk.dtype == torch.bfloat16), out.data_ptr(),
        ct.num_chunks, per_block, ct.tile, ct.e_b, ct.n_rows, f, w, piece,
        torch.cuda.current_stream(xk.device).cuda_stream)
    _build.check(lib, err, "cootile_spmm")
    tracing.launched("cootile_spmm")
    return out

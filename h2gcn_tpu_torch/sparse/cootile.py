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

from . import _build
from .gscatter import _operand

KB = 8  # chunks per step of the JAX package's grid; kept for table parity
# build_cootile's tile when none is given: the fastest of 256, 512 and 1024
# for the cluster-ordered 250K-node A2 at F = 64 on the H100, and for the
# 10K-node A2 at F = 64 and 128 (PERF.md, section 6)
DEFAULT_TILE = 256
_MAX_TILE = 1024  # the kernel's shared accumulator is tile x 32 f32
# table slots a thread block walks (chunks_per_block = this // e_b): its
# flush of up to tile x 32 outputs stays small beside its edges' gathers
_SLOTS_PER_BLOCK = 16384
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
                   n_cols=int(m))


def _chunks_per_block(ct: CooTile, f: int, device) -> int:
    """Chunks one thread block walks: :data:`_SLOTS_PER_BLOCK` worth, or
    fewer where that would leave under :data:`_MIN_BLOCKS_PER_SM` blocks per
    SM (one block per range and 32-feature tile)."""
    per_range = max(1, _SLOTS_PER_BLOCK // ct.e_b)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ranges = -(-_MIN_BLOCKS_PER_SM * sms // -(-f // 32))
    return max(1, min(per_range, -(-ct.num_chunks // ranges)))


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
                 precision: str = "highest") -> torch.Tensor:
    """``A @ x`` for a :class:`CooTile`: ``x`` [m, F] -> [n, F] float32.

    A CPU tensor takes :func:`cootile_spmm_plain`; a CUDA tensor launches
    the kernel (once) or raises.
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
    lib, _ = _build.library()
    err = lib.h2gcn_cootile_spmm(
        ct.ctr.data_ptr(), ct.ctc.data_ptr(), ct.row_ptr.data_ptr(),
        ct.rows.data_ptr(), ct.cols.data_ptr(), ct.vals.data_ptr(),
        xk.data_ptr(), int(xk.dtype == torch.bfloat16), out.data_ptr(),
        ct.num_chunks, _chunks_per_block(ct, f, xk.device), ct.tile, ct.e_b,
        ct.n_rows, f, torch.cuda.current_stream(xk.device).cuda_stream)
    _build.check(lib, err, "cootile_spmm")
    cootile_spmm.launches += 1
    return out


cootile_spmm.launches = 0  # kernel launches; chip_smoke.py reads it

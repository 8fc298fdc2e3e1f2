"""Host-side COO-chunk tables: edges chunked per ``T x T`` tile.

The host part of ``h2gcn_tpu/sparse/pallas_cootile.py``, built the same way
so the two packages can be compared table for table: edges are sorted by
(tile row, tile column), cut into ``e_b``-slot chunks (one tile pair per
chunk), every tile row gets at least one chunk (a zero filler), and each
tile row's chunk list is padded to a multiple of ``kb`` with zero-valued
fillers. The fused COO-chunk attention (:mod:`.attention_coo`) reads them.
The ``cootile_spmm`` kernel and its geometry model are not ported yet
(ROADMAP B3).
"""

from __future__ import annotations

import numpy as np

KB = 8  # chunks per step of the JAX package's grid; kept for table parity


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

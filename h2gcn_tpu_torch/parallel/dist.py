"""Distributed SpMM: edge-partitioned aggregation over ``torch.distributed``.

The port of ``h2gcn_tpu.parallel.dist``. The partition is the JAX
package's:

* nodes are padded to ``n_pad = D · n_local`` and row-sharded: rank ``d``
  owns rows ``[d·n_local, (d+1)·n_local)`` of every matrix and the matching
  slice of the feature and activation arrays;
* each rank owns ALL edges targeting its rows (a 1-D edge partition by
  destination).

The host builders (numpy, deterministic) build every shard's tables with a
leading device axis, exactly the JAX package's arrays; a rank moves only its
own shard to its device with ``local(mesh)`` (the counterpart of JAX's
``.local()`` inside ``shard_map``). The four modes differ in the exchange:

``allgather``     :func:`dist_spmm`: all-gather the features, reduce the
                  local edges (backward: a reduce-scatter);
``ring``          :func:`dist_spmm_ring`: node chunks rotate around the
                  ring while each rank reduces the edges of the chunk it
                  holds;
``halo``          :func:`dist_spmm_halo`: one ``all_to_all`` of the
                  boundary rows a neighbour needs, issued before the
                  interior reduce and waited on after it;
``halo-cootile``  :func:`dist_spmm_halo_cootile`: the halo exchange with
                  both local reduces on the COO-tile kernel
                  (``csrc/cootile_spmm.cu`` on the card).

The three flat-COO modes reduce with ``index_add`` on either device, the
op the JAX package uses there (``jax.ops.segment_sum``, not a Pallas
kernel); the kernel route of this layer is ``halo-cootile``, whose local
matrices are ``SparseMatrix(backend="cootile")`` with their Aᵀg backward.
The JAX package's SMEM cap on a shard's chunks is a TPU limit and is not
ported. :func:`h2gcn_tpu_torch.nn.model._aggregate` dispatches a graph
layer's aggregation to these functions when a hop matrix is a rank's shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from ..sparse import SparseMatrix, spmm
from . import _collectives
from .mesh import Mesh

_EDGE_BUCKET = 1024


def _dev(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def _segment(rows, cols, vals, x, n_out):
    """``sum_e vals[e] * x[cols[e]]`` into ``rows[e]``: [n_out, F]."""
    gathered = x[cols] * vals[:, None].to(x.dtype)
    return torch.zeros(n_out, x.shape[1], dtype=x.dtype,
                       device=x.device).index_add(0, rows, gathered)


def _row_blocks(csr, num_shards):
    n = csr.shape[0]
    n_local = -(-n // num_shards)
    return n_local, n_local * num_shards


def _bucket(e):
    return int(math.ceil(max(e, 1) / _EDGE_BUCKET)) * _EDGE_BUCKET


# ---------------------------------------------------------------- allgather
@dataclasses.dataclass
class DistSparseMatrix:
    """A rank's shard: its edges with local rows and global columns."""

    rows: torch.Tensor  # [E_pad] int64 local destination rows, sorted
    cols: torch.Tensor  # [E_pad] int64 global source columns
    vals: torch.Tensor  # [E_pad] float32
    n_local: int
    n_global: int
    mesh: Mesh


@dataclasses.dataclass
class ShardedMatrix:
    """Host tables of every shard, leading axis the device."""

    rows: np.ndarray  # [D, E_pad] int32
    cols: np.ndarray  # [D, E_pad] int32
    vals: np.ndarray  # [D, E_pad] float32
    n_local: int
    n_global: int

    def local(self, mesh: Mesh) -> DistSparseMatrix:
        r, d = mesh.rank, mesh.device
        return DistSparseMatrix(
            rows=_dev(self.rows[r], d, torch.int64),
            cols=_dev(self.cols[r], d, torch.int64),
            vals=_dev(self.vals[r], d), n_local=self.n_local,
            n_global=self.n_global, mesh=mesh)


def shard_matrix(mat, num_shards: int) -> Tuple[ShardedMatrix, int]:
    """Row-partition a square scipy matrix into ``num_shards`` edge shards,
    each padded to one edge count (in-bounds entries of value 0 on the last
    local row). Returns (sharded matrix, n_pad)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat).astype(np.float32)
    n = csr.shape[0]
    n_local, n_pad = _row_blocks(csr, num_shards)

    shards = []
    for d in range(num_shards):
        lo, hi = d * n_local, min((d + 1) * n_local, n)
        shards.append(csr[lo:hi].tocoo() if lo < n else sp.coo_matrix((0, n)))
    e_pad = _bucket(max(b.nnz for b in shards))

    rows = np.full((num_shards, e_pad), n_local - 1, dtype=np.int32)
    cols = np.zeros((num_shards, e_pad), dtype=np.int32)
    vals = np.zeros((num_shards, e_pad), dtype=np.float32)
    for d, block in enumerate(shards):
        order = np.lexsort((block.col, block.row))
        e = block.nnz
        rows[d, :e] = block.row[order]
        cols[d, :e] = block.col[order]
        vals[d, :e] = block.data[order]
    return ShardedMatrix(rows=rows, cols=cols, vals=vals, n_local=n_local,
                         n_global=n_pad), n_pad


def dist_spmm(dsm: DistSparseMatrix, x_local: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the ranks: all-gather the features, reduce the local
    edges. ``x_local`` [n_local, F] -> [n_local, F]. Backward: the
    reduce-scatter routes contributions to remote nodes to their owners."""
    x_global = _collectives.all_gather(x_local, dsm.mesh)
    return _segment(dsm.rows, dsm.cols, dsm.vals, x_global, dsm.n_local)


# --------------------------------------------------------------------- ring
@dataclasses.dataclass
class RingShard:
    """A rank's edges grouped by the rank that owns their source columns;
    ``cols`` are local to that source chunk."""

    rows: torch.Tensor  # [P, E_pad] int64 local dest rows, sorted per group
    cols: torch.Tensor  # [P, E_pad] int64 chunk-local source cols
    vals: torch.Tensor  # [P, E_pad] float32
    n_local: int
    n_global: int
    mesh: Mesh

    @property
    def num_shards(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class RingShardedMatrix:
    """Host tables for the ring schedule: ``[D, P, E_pad]``, device ``d``'s
    edges split into P groups by the device that owns the source."""

    rows: np.ndarray  # [D, P, E_pad] int32
    cols: np.ndarray  # [D, P, E_pad] int32
    vals: np.ndarray  # [D, P, E_pad] float32
    n_local: int
    n_global: int

    @property
    def num_shards(self) -> int:
        return self.rows.shape[1]

    def local(self, mesh: Mesh) -> RingShard:
        r, d = mesh.rank, mesh.device
        return RingShard(
            rows=_dev(self.rows[r], d, torch.int64),
            cols=_dev(self.cols[r], d, torch.int64),
            vals=_dev(self.vals[r], d), n_local=self.n_local,
            n_global=self.n_global, mesh=mesh)


def shard_matrix_ring(mat, num_shards: int
                      ) -> Tuple[RingShardedMatrix, int]:
    """Partition rows AND group each row-shard's edges by source chunk."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat).astype(np.float32)
    n = csr.shape[0]
    n_local, n_pad = _row_blocks(csr, num_shards)

    chunks = [[None] * num_shards for _ in range(num_shards)]
    for d in range(num_shards):
        lo, hi = d * n_local, min((d + 1) * n_local, n)
        block = csr[lo:hi] if lo < n else sp.csr_matrix((0, n))
        for s in range(num_shards):
            clo, chi = s * n_local, min((s + 1) * n_local, n)
            chunks[d][s] = block[:, clo:chi].tocoo()
    e_pad = _bucket(max(c.nnz for row in chunks for c in row))

    shape = (num_shards, num_shards, e_pad)
    rows = np.full(shape, n_local - 1, np.int32)
    cols = np.zeros(shape, np.int32)
    vals = np.zeros(shape, np.float32)
    for d in range(num_shards):
        for s in range(num_shards):
            sub = chunks[d][s]
            order = np.lexsort((sub.col, sub.row))
            e = sub.nnz
            rows[d, s, :e] = sub.row[order]
            cols[d, s, :e] = sub.col[order]
            vals[d, s, :e] = sub.data[order]
    return RingShardedMatrix(rows=rows, cols=cols, vals=vals,
                             n_local=n_local, n_global=n_pad,
                             ), n_pad


def dist_spmm_ring(rsm: RingShard, x_local: torch.Tensor) -> torch.Tensor:
    """``A @ x`` with a ring schedule: each rank reduces the edges of the
    node chunk it holds while the next chunk travels one step round the
    ring; peak memory O(n_local·F), not O(n·F). The partial sums add in
    the JAX package's order: own chunk first, then rank - 1, rank - 2..."""
    p, mesh = rsm.num_shards, rsm.mesh
    out, buf, src = None, x_local, mesh.rank
    for step in range(p):
        if step + 1 < p:
            nxt, pending = _collectives.permute_start(buf, mesh)
        part = _segment(rsm.rows[src], rsm.cols[src], rsm.vals[src], buf,
                        rsm.n_local)
        out = part if out is None else out + part
        if step + 1 < p:
            pending.wait()
            buf, src = nxt, (src - 1) % p
    return out


# --------------------------------------------------------------------- halo
@dataclasses.dataclass
class HaloShard:
    """A rank's interior edges (local source columns) and halo edges
    (columns into the receive buffer), and its send table."""

    rows_int: torch.Tensor   # [Ei_pad] int64
    cols_int: torch.Tensor   # [Ei_pad] int64 local source cols
    vals_int: torch.Tensor   # [Ei_pad] float32
    rows_halo: torch.Tensor  # [Eh_pad] int64
    cols_halo: torch.Tensor  # [Eh_pad] int64 rows of the receive buffer
    vals_halo: torch.Tensor  # [Eh_pad] float32
    send_idx: torch.Tensor   # [D * H] int64 local rows sent to each rank
    n_local: int
    n_global: int
    halo: int
    mesh: Mesh


@dataclasses.dataclass
class HaloShardedMatrix:
    """Host tables of the boundary exchange, leading axis the device:
    interior edges (source owned by the shard, reduced from ``x_local``
    with no dependence on the exchange) and halo edges (columns remapped
    into the ``[D, H]`` receive buffer); ``send_idx[owner, dest]`` lists
    the owner's local rows that ``dest`` needs (padded with row 0)."""

    rows_int: np.ndarray   # [D, Ei_pad] int32
    cols_int: np.ndarray   # [D, Ei_pad] int32
    vals_int: np.ndarray   # [D, Ei_pad] float32
    rows_halo: np.ndarray  # [D, Eh_pad] int32
    cols_halo: np.ndarray  # [D, Eh_pad] int32
    vals_halo: np.ndarray  # [D, Eh_pad] float32
    send_idx: np.ndarray   # [D(owner), D(dest), H] int32
    n_local: int
    n_global: int
    halo: int

    def local(self, mesh: Mesh) -> HaloShard:
        r, d = mesh.rank, mesh.device
        i64 = torch.int64
        return HaloShard(
            rows_int=_dev(self.rows_int[r], d, i64),
            cols_int=_dev(self.cols_int[r], d, i64),
            vals_int=_dev(self.vals_int[r], d),
            rows_halo=_dev(self.rows_halo[r], d, i64),
            cols_halo=_dev(self.cols_halo[r], d, i64),
            vals_halo=_dev(self.vals_halo[r], d),
            send_idx=_dev(self.send_idx[r].reshape(-1), d, i64),
            n_local=self.n_local, n_global=self.n_global, halo=self.halo,
            mesh=mesh)


def _halo_partition(csr, num_shards):
    """Row blocks, and each shard's needed columns of every other shard
    (sorted, unique; a shard's own columns never travel)."""
    import scipy.sparse as sp

    n = csr.shape[0]
    n_local, n_pad = _row_blocks(csr, num_shards)
    D = num_shards
    blocks, needed = [], [[None] * D for _ in range(D)]
    max_h = 1
    for d in range(D):
        lo, hi = d * n_local, min((d + 1) * n_local, n)
        block = csr[lo:hi].tocoo() if lo < n else sp.coo_matrix((0, n))
        blocks.append(block)
        src_shard = block.col // n_local
        for s in range(D):
            if s == d:
                needed[d][s] = np.empty(0, dtype=np.int64)
                continue
            u = np.unique(block.col[src_shard == s]).astype(np.int64)
            needed[d][s] = u
            max_h = max(max_h, len(u))
    h_pad = int(math.ceil(max_h / 8)) * 8
    return blocks, needed, n_local, n_pad, h_pad


def _send_table(needed, n_local, h_pad):
    """``send_idx[owner, dest]``: the owner's local rows ``dest`` needs."""
    D = len(needed)
    send_idx = np.zeros((D, D, h_pad), np.int32)
    for d in range(D):
        for dest in range(D):
            u = needed[dest][d]
            send_idx[d, dest, : len(u)] = u - d * n_local
    return send_idx


def _remap_halo(cols, src_shard, needed_d, h_pad):
    """Global halo columns -> rows of the receive buffer
    ``[src_shard * h_pad + position in needed_d[src_shard]]``."""
    remapped = np.zeros(len(cols), np.int64)
    for s, need in enumerate(needed_d):
        sel = src_shard == s
        if sel.any():
            remapped[sel] = s * h_pad + np.searchsorted(need, cols[sel])
    return remapped


def shard_matrix_halo(mat, num_shards: int
                      ) -> Tuple[HaloShardedMatrix, int]:
    """Row-partition plus boundary-exchange tables (host precompute)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat).astype(np.float32)
    D = num_shards
    blocks, needed, n_local, n_pad, h_pad = _halo_partition(csr, D)
    max_ei = max([1] + [int((b.col // n_local == d).sum())
                        for d, b in enumerate(blocks)])
    max_eh = max([1] + [int((b.col // n_local != d).sum())
                        for d, b in enumerate(blocks)])
    ei_pad, eh_pad = _bucket(max_ei), _bucket(max_eh)

    rows_int = np.full((D, ei_pad), n_local - 1, np.int32)
    cols_int = np.zeros((D, ei_pad), np.int32)
    vals_int = np.zeros((D, ei_pad), np.float32)
    rows_halo = np.full((D, eh_pad), n_local - 1, np.int32)
    cols_halo = np.zeros((D, eh_pad), np.int32)
    vals_halo = np.zeros((D, eh_pad), np.float32)
    for d, block in enumerate(blocks):
        order = np.lexsort((block.col, block.row))
        r, c, v = block.row[order], block.col[order], block.data[order]
        src_shard = c // n_local
        interior = src_shard == d
        ei = int(interior.sum())
        rows_int[d, :ei] = r[interior]
        cols_int[d, :ei] = c[interior] - d * n_local
        vals_int[d, :ei] = v[interior]
        hsel = ~interior
        eh = int(hsel.sum())
        rows_halo[d, :eh] = r[hsel]
        cols_halo[d, :eh] = _remap_halo(c[hsel], src_shard[hsel], needed[d],
                                        h_pad)
        vals_halo[d, :eh] = v[hsel]
    return HaloShardedMatrix(
        rows_int=rows_int, cols_int=cols_int, vals_int=vals_int,
        rows_halo=rows_halo, cols_halo=cols_halo, vals_halo=vals_halo,
        send_idx=_send_table(needed, n_local, h_pad), n_local=n_local,
        n_global=n_pad, halo=h_pad, ), n_pad


def dist_spmm_halo(hsm: HaloShard, x_local: torch.Tensor) -> torch.Tensor:
    """``A @ x`` with boundary-only exchange: (1) issue the all_to_all of
    the send rows, (2) reduce the interior edges from ``x_local``, which
    needs nothing of the exchange, while it travels, (3) wait, and reduce
    the halo edges from the receive buffer. Comm volume O(D·H·F) a rank;
    a rank's own rows never travel, so a world of one rank (every edge
    interior, the halo edges all padding) exchanges and reduces nothing
    more."""
    if hsm.mesh.size == 1:
        return _segment(hsm.rows_int, hsm.cols_int, hsm.vals_int, x_local,
                        hsm.n_local)
    recv, pending = _collectives.all_to_all_start(x_local[hsm.send_idx],
                                                  hsm.mesh)
    out = _segment(hsm.rows_int, hsm.cols_int, hsm.vals_int, x_local,
                   hsm.n_local)
    pending.wait()
    return out + _segment(hsm.rows_halo, hsm.cols_halo, hsm.vals_halo, recv,
                          hsm.n_local)


# ------------------------------------------------------------- halo-cootile
@dataclasses.dataclass
class HaloCooTileShard:
    """A rank's halo exchange with both local reduces on COO-tile
    matrices: ``interior`` [n_local, n_local] and ``halo`` [n_local,
    D·H] over the receive buffer, each with its transpose payload."""

    send_idx: torch.Tensor  # [D * H] int64
    interior: SparseMatrix
    halo_mat: SparseMatrix
    n_local: int
    n_global: int
    halo: int
    mesh: Mesh


@dataclasses.dataclass
class HaloCooTileMatrix:
    """The halo partition (:func:`shard_matrix_halo`) with each shard's
    interior and halo edge sets as scipy CSR matrices; ``local`` builds a
    rank's COO-tile payloads (the port's own chunk geometry,
    :func:`h2gcn_tpu_torch.sparse.cootile.build_cootile`) on its device."""

    send_idx: np.ndarray  # [D(owner), D(dest), H] int32
    interiors: list       # D scipy CSR [n_local, n_local]
    halos: list           # D scipy CSR [n_local, D * H]
    n_local: int
    n_global: int
    halo: int

    def local(self, mesh: Mesh) -> HaloCooTileShard:
        r, d = mesh.rank, mesh.device
        return HaloCooTileShard(
            send_idx=_dev(self.send_idx[r].reshape(-1), d, torch.int64),
            interior=SparseMatrix.from_scipy(self.interiors[r],
                                             backend="cootile", device=d),
            halo_mat=SparseMatrix.from_scipy(self.halos[r],
                                             backend="cootile", device=d),
            n_local=self.n_local, n_global=self.n_global, halo=self.halo,
            mesh=mesh)


def shard_matrix_halo_cootile(mat, num_shards: int
                              ) -> Tuple[HaloCooTileMatrix, int]:
    """The halo partition re-expressed as one interior and one halo CSR
    matrix a shard (padding entries dropped), for the COO-tile kernel."""
    import scipy.sparse as sp

    hsm, n_pad = shard_matrix_halo(mat, num_shards)
    D, n_local, h_pad = num_shards, hsm.n_local, hsm.halo

    def to_csr(rows, cols, vals, shape):
        m = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
        m.eliminate_zeros()  # padding slots carry explicit zeros
        return m

    interiors = [to_csr(hsm.rows_int[d], hsm.cols_int[d], hsm.vals_int[d],
                        (n_local, n_local)) for d in range(D)]
    halos = [to_csr(hsm.rows_halo[d], hsm.cols_halo[d], hsm.vals_halo[d],
                    (n_local, D * h_pad)) for d in range(D)]
    return HaloCooTileMatrix(send_idx=hsm.send_idx, interiors=interiors,
                             halos=halos, n_local=n_local,
                             n_global=hsm.n_global, halo=h_pad,
                             ), n_pad


def dist_spmm_halo_cootile(hcm: HaloCooTileShard,
                           x_local: torch.Tensor) -> torch.Tensor:
    """``A @ x`` with boundary-only exchange and COO-tile local reduces:
    the schedule of :func:`dist_spmm_halo`, both reduces through ``spmm``
    (the kernel on the card, forward and Aᵀg). A world of one rank has an
    empty halo matrix: the interior reduce alone, with no exchange."""
    if hcm.mesh.size == 1:
        return spmm(hcm.interior, x_local)
    recv, pending = _collectives.all_to_all_start(x_local[hcm.send_idx],
                                                  hcm.mesh)
    out = spmm(hcm.interior, x_local)
    pending.wait()
    return out + spmm(hcm.halo_mat, recv)


# ------------------------------------------------------------------ helpers
def pad_nodes(arr: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad the leading (node) axis to ``n_pad``."""
    if arr.shape[0] == n_pad:
        return arr
    pad_width = [(0, n_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)


_BUILDERS = {"allgather": shard_matrix, "ring": shard_matrix_ring,
             "halo": shard_matrix_halo,
             "halo-cootile": shard_matrix_halo_cootile}
HALO_MODES = tuple(_BUILDERS)


def shard_hops(mats: List, num_shards: int,
               mode: str = "allgather"):
    """Shard a list of hop matrices; returns (list of shards, n_pad).

    ``mode``: ``allgather`` (:class:`ShardedMatrix`), ``ring``
    (:class:`RingShardedMatrix`), ``halo`` (:class:`HaloShardedMatrix`) or
    ``halo-cootile`` (:class:`HaloCooTileMatrix`).
    """
    builder = _BUILDERS[mode]
    out, n_pad = [], None
    for m in mats:
        sm, n_pad = builder(m, num_shards)
        out.append(sm)
    return out, n_pad

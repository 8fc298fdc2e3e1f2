"""Sparse matrices on the device and the SpMM dispatch.

:class:`SparseMatrix` is the port of ``h2gcn_tpu.sparse.matrix``: padded
COO arrays with sorted rows (padding entries are in-bounds no-ops with value
0), plus at most one execution payload chosen at construction:

``dense``     the matrix as a dense tensor; ``torch.matmul``.
``segment``   the COO arrays alone; gather + ``index_add_``.
``gscatter``  the COO arrays' row-major entries with a row pointer and
              work items for ``csrc/gscatter.cu`` (:mod:`.gscatter`).
``cootile``   COO-tile chunk tables for ``csrc/cootile_spmm.cu``
              (:mod:`.cootile`): the at-scale path for large graphs, with
              their nodes cluster-ordered (``transforms.cluster_order``).
``bsr``       dense B x B blocks: 128-blocks for ``csrc/bsr_spmm.cu``
              (:mod:`.bsr_spmm`), 256-blocks as the GAT attention mask
              (:mod:`.attention`), whose kernels walk edge lists built
              once from it.
``attn``      the COO arrays plus an O(nnz) fused-attention payload for
              GAT past the BSR budget: gather tables (:mod:`.attention_gather`)
              or COO-chunk tables (:mod:`.attention_coo`). Its SpMM runs on
              the COO arrays, as ``segment``.

``auto`` takes one of these from what the matrix holds
(:func:`_auto_backend`): ``segment`` on the CPU; on CUDA ``bsr`` where its
entries per occupied 128-block reach the measured crossover of the two
kernels (1,200 in f32, 500 in bf16) and the payload fits 4 GiB, else
``gscatter``. Each matrix it routes counts as ``route.<backend>``
(:func:`~h2gcn_tpu_torch.tracing.count`).

:func:`spmm` is differentiable in ``x``: its backward is ``spmm`` of the
transpose view, which carries the transpose payload (or, for a symmetric
matrix, is the matrix itself).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from .attention_coo import build_attn_coo
from .attention_gather import build_gatherattn
from .bsr_spmm import bsr_spmm
from .cootile import CooTile, build_cootile, cootile_spmm
from .gscatter import RowMajor, build_row_major, gscatter_spmm

_NNZ_BUCKET = 1024
_DEFAULT_BLOCK = 128
_BACKENDS = ("auto", "dense", "segment", "gscatter", "bsr", "cootile", "attn")


# auto's route to bsr_spmm (#2) on CUDA: by precision, the entries per
# occupied 128-block from which #2 beats gscatter (#1) at F = 64 and 128 on
# the H100 (PERF.md section 6's crossover table), and the most bytes of BSR
# payload, the transpose's included, that a matrix may take
BSR_MIN_ENTRIES_PER_BLOCK = {"highest": 1200, "default": 500}
BSR_PAYLOAD_CAP = 4 << 30


def block_occupancy(csr, block_size: int = _DEFAULT_BLOCK) -> Tuple[int, int]:
    """``(occupied, fillers)`` of a scipy CSR matrix cut into ``block_size``
    blocks: the blocks that hold an entry, and the zero blocks
    :func:`_build_bsr` adds for block rows and columns that hold none.

    Linear in the entries, whatever the size of the block grid: the
    entries' block columns, grouped by block row through ``indptr``, are
    transposed by a counting sort (scipy's ``tocsc``), which leaves each
    block column's block rows sorted, so an occupied block is a change of
    block row within a block column.
    """
    import scipy.sparse as sp

    n, m = csr.shape
    n_rb = max(1, -(-n // block_size))
    n_cb = max(1, -(-m // block_size))
    ptr = csr.indptr[np.minimum(np.arange(n_rb + 1) * block_size, n)]
    by_row = sp.csr_matrix(
        (np.ones(csr.indices.size, np.int8), csr.indices // block_size, ptr),
        shape=(n_rb, n_cb))
    by_col = by_row.tocsc()
    idx, cptr = by_col.indices, by_col.indptr
    first = np.ones(idx.size, dtype=bool)
    np.not_equal(idx[1:], idx[:-1], out=first[1:])
    live_cols = np.diff(cptr) > 0
    first[cptr[:-1][live_cols]] = True
    fillers = (int((np.diff(ptr) == 0).sum())
               + n_cb - int(live_cols.sum()))
    return int(first.sum()), fillers


def _auto_backend(csr, *, symmetric: bool, precision: str,
                  device_type: str) -> str:
    """``backend='auto'``: the route of a scipy CSR matrix, from what it
    holds.

    - On the CPU: ``segment``, as in the JAX package.
    - On CUDA: ``bsr`` (#2, dense 128-blocks) where the matrix holds at
      least ``BSR_MIN_ENTRIES_PER_BLOCK[precision]`` entries per occupied
      128-block and its payload (a block is 64 KiB in f32, 32 KiB in bf16;
      the fillers count, and the transpose's blocks where the matrix is
      not symmetric) is at most :data:`BSR_PAYLOAD_CAP`; else ``gscatter``
      (#1).

    #1 pays per entry (a gathered row of x and an add), #2 per block, so
    the entries per occupied block decide. On the H100, F = 64 and 128,
    the two cross at 900-1,050 entries a block in ``highest`` (f32) and at
    330-440 in ``default`` (bf16 operands), on the 1,681 blocks of
    squirrel's Â₂ thinned at random and on the 6,240 of the 10K
    ``bench.py`` Â₂ (``scripts/spmm_crossover.py``). Squirrel's Â₂ (14,094
    entries a block) runs 13-16x faster on #2; its Â₁ (258) stays on #1.
    The JAX package's rule (``dense`` below 8K nodes, BSR from 90 entries
    a block) was measured on a TPU; ``auto`` routes to no library kernel.
    """
    if device_type == "cpu":
        return "segment"
    least = BSR_MIN_ENTRIES_PER_BLOCK.get(precision)
    if device_type != "cuda" or least is None or csr.nnz == 0:
        return "gscatter"
    occupied, fillers = block_occupancy(csr)
    if csr.nnz < least * occupied:
        return "gscatter"
    itemsize = 2 if precision == "default" else 4
    payload = ((occupied + fillers) * _DEFAULT_BLOCK ** 2 * itemsize
               * (1 if symmetric else 2))
    return "bsr" if payload <= BSR_PAYLOAD_CAP else "gscatter"


@dataclasses.dataclass
class BSR:
    """Dense B x B blocks sorted by (block_row, block_col); every block row
    and every block column holds at least one block (zero fillers), so
    every output tile is written in both directions."""

    blocks: torch.Tensor        # [nb, B, B] f32 or bf16
    block_rows: torch.Tensor    # [nb] int32, ascending
    block_cols: torch.Tensor    # [nb] int32
    row_ptr: torch.Tensor       # [n_row_blocks + 1] int32 first block of each row
    # the blocks in (block_col, block_row) order, the JAX package's
    # host-built schedule of transpose-direction passes, and the first
    # entry of each block column in it
    colmajor_order: torch.Tensor  # [nb] int32
    col_ptr: torch.Tensor       # [n_col_blocks + 1] int32
    block_size: int = _DEFAULT_BLOCK
    n_row_blocks: int = 1
    n_col_blocks: int = 1
    # bsr_spmm's work items by block budget (bsr_spmm.build_items), on the
    # payload's device; filled at the first launch
    schedules: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]


@dataclasses.dataclass
class SparseMatrix:
    """Padded-COO sparse matrix with an optional dense / BSR / gscatter /
    COO-tile payload. ``rows`` is sorted ascending; padding entries use
    ``rows = n-1``, ``cols = m-1``, ``vals = 0``."""

    rows: torch.Tensor                # [nnz_pad] int32, sorted
    cols: torch.Tensor                # [nnz_pad] int32
    vals: torch.Tensor                # [nnz_pad] float32
    dense: Optional[torch.Tensor]
    bsr: Optional[BSR]
    bsr_t: Optional[BSR]              # BSR of the transpose (backward)
    shape: Tuple[int, int]
    nnz: int
    # CSC-order permutation of the padded COO arrays, precomputed on the
    # host; None for symmetric matrices (the transpose is the matrix)
    t_perm: Optional[torch.Tensor] = None
    # #1's payload over cols and vals; the transpose's over a row-major
    # copy of its own
    gsc: Optional[RowMajor] = None
    gsc_t: Optional[RowMajor] = None
    coot: Optional[CooTile] = None
    coot_t: Optional[CooTile] = None  # COO-tile tables of the transpose
    backend: str = "segment"
    symmetric: bool = False
    # "highest": f32 operands; "default": bf16 operands, f32 sums
    precision: str = "highest"
    # the fused-attention payload of backend "attn" (AttnCoo or GatherAttn)
    attn: Optional[object] = None

    def todense(self) -> torch.Tensor:
        """The matrix as a dense tensor on its device (duplicates summed)."""
        if self.dense is not None:
            return self.dense
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.rows.long(), self.cols.long()), self.vals,
                              accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sp

        if self.backend == "dense" and self.dense is not None:
            return sp.csr_matrix(self.dense.float().cpu().numpy())
        r = self.rows[: self.nnz].cpu().numpy()
        c = self.cols[: self.nnz].cpu().numpy()
        v = self.vals[: self.nnz].cpu().numpy()
        return sp.coo_matrix((v, (r, c)), shape=self.shape).tocsr()

    def transpose_view(self) -> "SparseMatrix":
        """A SparseMatrix computing ``A^T @ x``, used by the backward."""
        if self.symmetric:
            return self
        order = (self.t_perm if self.t_perm is not None
                 else torch.argsort(self.cols, stable=True))
        return SparseMatrix(
            rows=self.cols[order],
            cols=self.rows[order],
            vals=self.vals[order],
            dense=None if self.dense is None else self.dense.T,
            bsr=self.bsr_t,
            bsr_t=self.bsr,
            gsc=self.gsc_t,
            gsc_t=self.gsc,
            coot=self.coot_t,
            coot_t=self.coot,
            shape=(self.shape[1], self.shape[0]),
            nnz=self.nnz,
            # the attention payloads are orientation-specific and their
            # backward never dispatches through a transposed view: the view
            # carries none and reports "segment"
            backend="segment" if self.backend == "attn" else self.backend,
            symmetric=False,
            precision=self.precision,
        )

    @classmethod
    def from_scipy(
        cls,
        mat,
        *,
        backend: str = "auto",
        block_size: int = _DEFAULT_BLOCK,
        precision: str = "highest",
        device="cpu",
        attn_tile: int = 256,
        attn_impl: str = "coo",
    ) -> "SparseMatrix":
        """Build from any scipy sparse matrix on the host, then move to
        ``device``. Values are f32; the dense and BSR payloads are stored
        in bf16 for ``precision="default"`` (read in half the bytes). A
        non-symmetric matrix also gets the transpose payload its backward
        reads. ``backend="attn"`` builds the ``attn_impl`` ("gather" or
        "coo", with ``attn_tile``-row tiles) attention payload."""
        import scipy.sparse as sp

        device = torch.device(device)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown sparse backend {backend!r}")
        if backend == "attn" and attn_impl not in ("gather", "coo"):
            raise ValueError(f"unknown attention payload {attn_impl!r}")
        pdt = torch.bfloat16 if precision == "default" else torch.float32
        dtype = np.float32

        csr = sp.csr_matrix(mat).astype(dtype)
        csr.sum_duplicates()
        n, m = csr.shape
        coo = csr.tocoo()
        nnz = coo.nnz
        symmetric = bool(n == m and (abs(csr - csr.T)).nnz == 0)

        if backend == "auto":
            backend = _auto_backend(csr, symmetric=symmetric,
                                    precision=precision,
                                    device_type=device.type)
            tracing.count("route." + backend)

        if backend == "dense":
            # the dense payload is authoritative; the COO arrays are no-op
            # placeholders
            pad = 8
            rows = np.full(pad, n - 1, dtype=np.int32)
            cols = np.full(pad, m - 1, dtype=np.int32)
            vals = np.zeros(pad, dtype=dtype)
        else:
            pad = max(_NNZ_BUCKET,
                      int(math.ceil(max(nnz, 1) / _NNZ_BUCKET)) * _NNZ_BUCKET)
            rows = np.full(pad, n - 1, dtype=np.int32)
            cols = np.full(pad, m - 1, dtype=np.int32)
            vals = np.zeros(pad, dtype=dtype)
            rows[:nnz] = coo.row
            cols[:nnz] = coo.col
            vals[:nnz] = coo.data

        dense = bsr = bsr_t = gsc = gsc_t = coot = coot_t = None
        if backend == "dense":
            dense = torch.from_numpy(csr.toarray()).to(device=device, dtype=pdt)
        elif backend == "bsr":
            bsr = _build_bsr(csr, block_size, pdt, device)
            if not symmetric:
                bsr_t = _build_bsr(sp.csr_matrix(csr.T), block_size, pdt,
                                   device)
        elif backend == "gscatter":
            # the forward reads the COO arrays made below; the backward a
            # row-major copy of the transpose (int32 columns, f32 values)
            if not symmetric:
                t = sp.csr_matrix(csr.T)
                t.sort_indices()
                gsc_t = build_row_major(
                    t.indptr, torch.from_numpy(t.indices.astype(np.int32)).to(
                        device), torch.from_numpy(t.data).to(device), n)
        elif backend == "cootile":
            # one table set serves both precisions: the geometry does not
            # depend on it
            coot = build_cootile(csr, device=device)
            if not symmetric:
                coot_t = build_cootile(sp.csr_matrix(csr.T), device=device)

        attn = None
        if backend == "attn":
            if attn_impl == "gather":
                attn = build_gatherattn(csr, device=device)
            else:
                attn = build_attn_coo(csr, tile=attn_tile, device=device)

        t_perm = None
        if not symmetric:
            t_perm = torch.from_numpy(
                np.argsort(cols, kind="stable").astype(np.int32)).to(device)
        cols_d = torch.from_numpy(cols).to(device)
        vals_d = torch.from_numpy(vals).to(device)
        if backend == "gscatter":
            gsc = build_row_major(csr.indptr, cols_d, vals_d, m)
        return cls(
            rows=torch.from_numpy(rows).to(device),
            cols=cols_d,
            vals=vals_d,
            dense=dense,
            bsr=bsr,
            bsr_t=bsr_t,
            gsc=gsc,
            gsc_t=gsc_t,
            coot=coot,
            coot_t=coot_t,
            t_perm=t_perm,
            shape=(n, m),
            nnz=nnz,
            backend=backend,
            symmetric=symmetric,
            precision=precision,
            attn=attn,
        )


def _build_bsr(csr, block_size: int, payload_dtype=torch.float32,
               device="cpu") -> BSR:
    """Tile a scipy CSR matrix into dense B x B blocks (host-side).

    Zero filler blocks make every block row and every block column appear
    at least once: forward passes write each output row tile, and
    transpose-direction passes each column tile.
    """
    import scipy.sparse as sp

    B = block_size
    n, m = csr.shape
    n_rb = max(1, -(-n // B))
    n_cb = max(1, -(-m // B))
    padded = sp.csr_matrix(csr, copy=False)
    padded.resize((n_rb * B, n_cb * B))
    sbsr = padded.tobsr(blocksize=(B, B))
    sbsr.sort_indices()

    counts = np.diff(sbsr.indptr)
    block_rows = np.repeat(np.arange(n_rb, dtype=np.int32), counts)
    block_cols = sbsr.indices.astype(np.int32)
    blocks = np.asarray(sbsr.data, dtype=csr.dtype)

    empty_rows = np.where(counts == 0)[0].astype(np.int32)
    present_cols = np.unique(block_cols)
    empty_cols = np.setdiff1d(
        np.arange(n_cb, dtype=np.int32), present_cols
    ).astype(np.int32)
    n_fill = empty_rows.size + empty_cols.size
    if n_fill:
        blocks = np.concatenate(
            [blocks, np.zeros((n_fill, B, B), dtype=blocks.dtype)], axis=0
        )
        block_rows = np.concatenate(
            [block_rows, empty_rows,
             np.zeros(empty_cols.size, dtype=np.int32)]
        )
        block_cols = np.concatenate(
            [block_cols, np.zeros(empty_rows.size, dtype=np.int32),
             empty_cols]
        )
        order = np.lexsort((block_cols, block_rows))
        blocks, block_rows, block_cols = (blocks[order], block_rows[order],
                                          block_cols[order])

    row_ptr = np.searchsorted(block_rows, np.arange(n_rb + 1)).astype(np.int32)
    colmajor = np.lexsort((block_rows, block_cols)).astype(np.int32)
    col_ptr = np.searchsorted(block_cols[colmajor],
                              np.arange(n_cb + 1)).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BSR(
        blocks=torch.from_numpy(blocks).to(device=device, dtype=payload_dtype),
        block_rows=dev(block_rows),
        block_cols=dev(block_cols),
        row_ptr=dev(row_ptr),
        colmajor_order=dev(colmajor),
        col_ptr=dev(col_ptr),
        block_size=B,
        n_row_blocks=n_rb,
        n_col_blocks=n_cb,
    )


# ---------------------------------------------------------------------------
# SpMM: y = A @ x with backend dispatch and an autograd backward (A^T @ g).
# ---------------------------------------------------------------------------


def _spmm_segment(sm: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    gathered = x[sm.cols] * sm.vals[:, None].to(x.dtype)
    out = torch.zeros(sm.shape[0], x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, sm.rows, gathered)


def _spmm_impl(sm: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    if sm.backend == "dense" and sm.dense is not None:
        a = sm.dense
        if sm.precision == "default" or a.dtype == torch.bfloat16:
            # bf16 operands, f32 products and sums
            a = a.to(torch.bfloat16).to(torch.float32)
            x = x.to(torch.bfloat16).to(torch.float32)
        return torch.matmul(a.to(x.dtype), x)
    if sm.backend == "bsr" and sm.bsr is not None:
        return bsr_spmm(sm.bsr, x, n_out=sm.shape[0], precision=sm.precision)
    if sm.backend == "gscatter" and sm.gsc is not None:
        return gscatter_spmm(sm.gsc, x, precision=sm.precision)
    if sm.backend == "cootile" and sm.coot is not None:
        return cootile_spmm(sm.coot, x, precision=sm.precision)
    if sm.backend not in ("segment", "attn") and x.device.type != "cpu":
        # on the card a kernel backend launches its kernel or raises
        raise RuntimeError(
            f"spmm: backend {sm.backend!r} has no payload for this matrix "
            f"on {x.device}; SparseMatrix.from_scipy builds it")
    # the COO arrays alone; on the CPU also a kernel backend whose payload
    # was not built, as in the JAX package
    return _spmm_segment(sm, x)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sm):
        ctx.sm = sm
        with tracing.span("spmm", backend=sm.backend, F=x.shape[1],
                          direction="forward"):
            return _spmm_impl(sm, x)

    @staticmethod
    def backward(ctx, g):
        with tracing.span("spmm", backend=ctx.sm.backend, F=g.shape[1],
                          direction="backward"):
            return _spmm_impl(ctx.sm.transpose_view(), g.contiguous()), None


def spmm(sm: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a 2-D ``x`` [m, F] -> [n, F].

    Differentiable in ``x`` (gradient ``A^T @ g``); the matrix is a
    constant.
    """
    return _SpMM.apply(x, sm)

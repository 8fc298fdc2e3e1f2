"""Sparse matrices on the device and the SpMM dispatch.

:class:`SparseMatrix` is the port of ``h2gcn_tpu.sparse.matrix``: padded
COO arrays with sorted rows (padding entries are in-bounds no-ops with value
0), plus at most one execution payload chosen at construction:

``dense``     the matrix as a dense tensor; ``torch.matmul``.
``segment``   the COO arrays alone; gather + ``index_add_``.
``gscatter``  chunk tables for ``csrc/gscatter.cu`` (:mod:`.gscatter`).
``cootile``   COO-tile chunk tables for ``csrc/cootile_spmm.cu``
              (:mod:`.cootile`): the at-scale path for large graphs, with
              their nodes cluster-ordered (``transforms.cluster_order``).
``bsr``       dense B x B blocks: 128-blocks for ``csrc/bsr_spmm.cu``
              (:mod:`.bsr_spmm`), 256-blocks as the GAT attention mask of
              ``csrc/gat_attention.cu`` (:mod:`.attention`).
``attn``      the COO arrays plus an O(nnz) fused-attention payload for
              GAT past the BSR budget: gather tables (:mod:`.attention_gather`)
              or COO-chunk tables (:mod:`.attention_coo`). Its SpMM runs on
              the COO arrays, as ``segment``.

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

from .attention_coo import build_attn_coo
from .attention_gather import build_gatherattn
from .bsr_spmm import bsr_spmm
from .cootile import CooTile, build_cootile, cootile_spmm
from .gscatter import SPMM_TILE, GScatter, build_gscatter, gscatter_spmm

_NNZ_BUCKET = 1024
_DEFAULT_BLOCK = 128
_BACKENDS = ("auto", "dense", "segment", "gscatter", "bsr", "cootile", "attn")


def _auto_backend(device: torch.device) -> str:
    """``backend='auto'``: ``segment`` on the CPU, as in the JAX package.

    On CUDA it resolves to ``gscatter`` for now. The JAX package's
    crossovers (dense below 8K nodes, BSR and cootile by block occupancy)
    were measured on a TPU and do not carry over; the port keeps one
    kernel backend until it has measured its own (ROADMAP).
    """
    return "segment" if device.type == "cpu" else "gscatter"


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
    gsc: Optional[GScatter] = None
    gsc_t: Optional[GScatter] = None
    coot: Optional[CooTile] = None
    coot_t: Optional[CooTile] = None  # COO-tile tables of the transpose
    backend: str = "segment"
    symmetric: bool = False
    # "highest": f32 operands; "default": bf16 operands, f32 sums
    precision: str = "highest"
    # the fused-attention payload of backend "attn" (AttnCoo or GatherAttn)
    attn: Optional[object] = None

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
            backend = _auto_backend(device)

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
            gsc = build_gscatter(csr, tile=SPMM_TILE, device=device)
            if not symmetric:
                gsc_t = build_gscatter(sp.csr_matrix(csr.T), tile=SPMM_TILE,
                                       device=device)
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
        return cls(
            rows=torch.from_numpy(rows).to(device),
            cols=torch.from_numpy(cols).to(device),
            vals=torch.from_numpy(vals).to(device),
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
        return _spmm_impl(sm, x)

    @staticmethod
    def backward(ctx, g):
        return _spmm_impl(ctx.sm.transpose_view(), g.contiguous()), None


def spmm(sm: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a 2-D ``x`` [m, F] -> [n, F].

    Differentiable in ``x`` (gradient ``A^T @ g``); the matrix is a
    constant.
    """
    return _SpMM.apply(x, sm)

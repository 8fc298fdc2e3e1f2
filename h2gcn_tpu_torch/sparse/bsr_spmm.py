"""Block-sparse-row SpMM: the CUDA kernel's wrapper and its plain PyTorch
version.

``A`` is a :class:`~h2gcn_tpu_torch.sparse.matrix.BSR`: dense ``B x B``
blocks sorted by (block row, block column), with a zero filler block in
every otherwise empty block row. :func:`bsr_spmm` launches
``csrc/bsr_spmm.cu`` (replacing ``h2gcn_tpu/sparse/pallas_spmm.py``'s
kernel) on a CUDA tensor and takes :func:`bsr_spmm_plain` only for a CPU
tensor. The kernel's thread blocks take work items that :func:`build_items`
cuts from the payload's ``row_ptr``, kept beside the payload.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import _build

_KERNEL_BLOCK = 128  # the block size csrc/bsr_spmm.cu is written for
# blocks one work item multiplies at most
BLOCKS_PER_ITEM = 8
# ...but a small payload gets smaller items, so that the grid still holds
# this many thread blocks per SM
_MIN_BLOCKS_PER_SM = 4


def build_items(row_ptr, budget: int) -> np.ndarray:
    """The kernel's work items (numpy only): each block row's blocks cut
    into ``ceil(n / budget)`` near-equal runs. Returns int32 ``[n_items,
    3]`` rows ``(block row, first block, end block)``, in block-row order;
    they cover every block once, and every block row (each holds at least
    its filler block) gets at least one item."""
    ptr = np.asarray(row_ptr, np.int64)
    budget = max(1, int(budget))
    counts = np.diff(ptr)
    parts = np.maximum(-(-counts // budget), 1)
    br = np.repeat(np.arange(len(counts)), parts)
    k = np.arange(int(parts.sum())) - np.repeat(np.cumsum(parts) - parts,
                                                parts)
    lo = ptr[br] + (k * counts[br]) // parts[br]
    hi = ptr[br] + ((k + 1) * counts[br]) // parts[br]
    return np.stack([br, lo, hi], axis=1).astype(np.int32)


def work_items(bsr, f: int, device):
    """The work items the kernel launches for x of ``f`` features on
    ``device`` (:func:`build_items` on the device): at most
    :data:`BLOCKS_PER_ITEM` blocks each, fewer where that would leave under
    :data:`_MIN_BLOCKS_PER_SM` thread blocks per SM (one block per item and
    feature tile of 64, or of 128 past 64 features). Built once for each
    budget and kept beside the payload."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_ftiles = -(-f // (64 if f <= 64 else 128))
    items = -(-_MIN_BLOCKS_PER_SM * sms // n_ftiles)
    budget = max(1, min(BLOCKS_PER_ITEM, -(-bsr.num_blocks // items)))
    if budget not in bsr.schedules:
        bsr.schedules[budget] = torch.from_numpy(build_items(
            bsr.row_ptr.cpu().numpy(), budget)).to(bsr.row_ptr.device)
    return bsr.schedules[budget]


def _operands(bsr, x: torch.Tensor, precision: str):
    """Payload and x in the type the product reads: bf16 for "default" or a
    bf16 payload, else f32 (the payload is converted only if it was stored
    in another type)."""
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    bf16 = precision == "default" or bsr.blocks.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    return bsr.blocks.to(dt), x.to(dt)


def bsr_spmm_plain(bsr, x: torch.Tensor, *, n_out: int,
                   precision: str = "highest") -> torch.Tensor:
    """The plain PyTorch version: one ``einsum`` per block, then
    ``index_add_`` into the block rows. Runs on any device; the reference
    the kernel is held against."""
    blocks, xk = _operands(bsr, x, precision)
    B = bsr.block_size
    m, f = xk.shape
    m_pad = bsr.n_col_blocks * B
    xp = torch.zeros(m_pad, f, dtype=torch.float32, device=xk.device)
    xp[:m] = xk.to(torch.float32)
    xb = xp.reshape(bsr.n_col_blocks, B, f)[bsr.block_cols.to(torch.int64)]
    prod = torch.einsum("bij,bjf->bif", blocks.to(torch.float32), xb)
    out = torch.zeros(bsr.n_row_blocks, B, f, dtype=torch.float32,
                      device=xk.device)
    out.index_add_(0, bsr.block_rows.to(torch.int64), prod)
    return out.reshape(-1, f)[:n_out]


def bsr_spmm(bsr, x: torch.Tensor, *, n_out: int,
             precision: str = "highest") -> torch.Tensor:
    """``A @ x`` for a BSR ``A``: ``x`` [m, F] -> [n_out, F] float32.

    A CPU tensor takes :func:`bsr_spmm_plain`; a CUDA tensor launches the
    kernel (once) or raises.
    """
    if x.device.type == "cpu":
        return bsr_spmm_plain(bsr, x, n_out=n_out, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {x.device}")
    B = bsr.block_size
    if B != _KERNEL_BLOCK:
        raise ValueError(f"bsr_spmm: the kernel takes {_KERNEL_BLOCK}-blocks,"
                         f" not {B}")
    if x.dim() != 2 or x.shape[0] > bsr.n_col_blocks * B:
        raise ValueError(f"bsr_spmm: x {tuple(x.shape)} does not fit "
                         f"{bsr.n_col_blocks} column blocks")
    if n_out > bsr.n_row_blocks * B:
        raise ValueError(f"bsr_spmm: n_out {n_out} > "
                         f"{bsr.n_row_blocks} row blocks")
    blocks, xk = _operands(bsr, x, precision)
    xk = xk.contiguous()
    for t in (bsr.row_ptr, bsr.block_cols, blocks):
        if t.device != xk.device or not t.is_contiguous():
            raise ValueError(f"bsr_spmm: tables must be contiguous and on "
                             f"{xk.device}")
    if blocks.data_ptr() % 16:
        raise ValueError("bsr_spmm: the payload must be 16-byte aligned")
    m, f = xk.shape
    out = torch.zeros(n_out, f, dtype=torch.float32, device=xk.device)
    if f == 0 or n_out == 0:
        return out
    items = work_items(bsr, f, xk.device)
    lib, _ = _build.library()
    err = lib.h2gcn_bsr_spmm(
        items.data_ptr(), int(items.shape[0]), bsr.block_cols.data_ptr(),
        blocks.data_ptr(), xk.data_ptr(),
        int(blocks.dtype == torch.bfloat16), out.data_ptr(), m, f, n_out,
        torch.cuda.current_stream(xk.device).cuda_stream)
    _build.check(lib, err, "bsr_spmm")
    tracing.launched("bsr_spmm")
    return out

"""Fused multi-head graph attention over a BSR mask: the CUDA kernels'
wrappers, their plain PyTorch versions, and the differentiable entry point.

The port of ``h2gcn_tpu/sparse/pallas_attention.py``. For each head ``k``
of ``H`` (``F`` features a head, heads concatenated along the feature
axis), over the edges ``(i, j)`` of a binary BSR mask (entries ``> 0``):

    e_ij  = LeakyReLU_slope(f1[i, k] + f2[j, k])
    out_i = sum_j softmax_j(e_ij) h[j, kF:(k+1)F]

``f1, f2: [N, H]``; ``h: [N, H*F]``. Three kernels of
``csrc/gat_attention.cu`` compute it without any edge-sized intermediate:

- :func:`gat_fwd_stats`: ``out`` and the row max ``m`` and normalizer ``l``;
- :func:`gat_bwd_row`: ``df1``, recomputing alpha from ``m`` and ``l``;
- :func:`gat_bwd_col`: ``dh`` and ``df2``, walking the blocks column by
  column (``colmajor_order`` / ``col_ptr``).

Each takes padded operands (``n_pad = n_blocks * B`` rows) and returns
padded outputs. A CPU tensor takes the plain version beside it; a CUDA
tensor launches the kernel or raises. :func:`gat_attention` is the
``torch.autograd.Function`` over them; the backward computes
``D_i = g_i . out_i`` per head in torch, as the JAX package does.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30  # the JAX package's sentinel; -inf would give NaN rescales
MAX_HF = 512  # the most H * F csrc/gat_attention.cu takes


def _leaky(pre, slope):
    return torch.where(pre >= 0, pre, slope * pre)


def _geometry(bsr):
    if bsr.n_row_blocks != bsr.n_col_blocks:
        raise ValueError("gat attention: the mask must be square, not "
                         f"{bsr.n_row_blocks} x {bsr.n_col_blocks} blocks")
    return bsr.block_size, bsr.n_row_blocks * bsr.block_size


def pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``x`` [n, w] as float32 [n_pad, w], zero rows appended."""
    out = torch.zeros(n_pad, x.shape[1], dtype=torch.float32, device=x.device)
    out[: x.shape[0]] = x
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions: block by block over the BSR tables, with the JAX
# sentinel, on padded operands. The references the kernels are held against.
# ---------------------------------------------------------------------------


def _row_blocks(bsr, br):
    lo, hi = int(bsr.row_ptr[br]), int(bsr.row_ptr[br + 1])
    return slice(lo, hi), bsr.block_cols[lo:hi].to(torch.int64)


def _col_blocks(bsr, bc):
    lo, hi = int(bsr.col_ptr[bc]), int(bsr.col_ptr[bc + 1])
    idx = bsr.colmajor_order[lo:hi].to(torch.int64)
    return idx, bsr.block_rows[idx].to(torch.int64)


def _alpha(mask, pre, m, l, slope):
    """alpha and leaky' of blocks [k, i, j, H] from the saved stats m, l
    [k or 1, i, 1, H]; both 0 off the mask."""
    p = torch.where(mask, torch.exp(_leaky(pre, slope) - m), 0.0)
    alpha = p / torch.clamp(l, min=1e-16)
    dleaky = torch.where(mask, torch.where(pre >= 0, 1.0, slope), 0.0)
    return alpha, dleaky


def gat_fwd_stats_plain(bsr, f1p, f2p, hp, *, num_heads: int, feat: int,
                        slope: float = 0.2):
    """-> ``(out [n_pad, H*F], m [n_pad, H], l [n_pad, H])``.

    The sums ``l`` and ``p @ h`` run in float64 and are rounded to float32
    once: a float32 ``einsum`` sums in an order that depends on the CPU
    threads free at the time, and moved its result by up to 3e-5 between
    calls on a loaded machine."""
    B, n_pad = _geometry(bsr)
    H, F = num_heads, feat
    f1b = f1p.reshape(-1, B, H)
    f2b = f2p.reshape(-1, B, H)
    hb = hp.reshape(-1, B, H, F)
    out = torch.zeros(n_pad // B, B, H, F, dtype=torch.float32,
                      device=hp.device)
    m = torch.full((n_pad // B, B, H), NEG_INF, dtype=torch.float32,
                   device=hp.device)
    l = torch.zeros(n_pad // B, B, H, dtype=torch.float32, device=hp.device)
    for br in range(n_pad // B):
        sel, cols = _row_blocks(bsr, br)
        if cols.numel() == 0:
            continue
        mask = (bsr.blocks[sel] > 0)[..., None]               # [k, i, j, 1]
        e = _leaky(f1b[br][None, :, None, :] + f2b[cols][:, None], slope)
        e = torch.where(mask, e, NEG_INF)                     # [k, i, j, H]
        mi = torch.amax(e, dim=(0, 2))                        # [i, H]
        p = torch.where(mask, torch.exp(e - mi[None, :, None, :]),
                        0.0).double()
        li = p.sum(dim=(0, 2))
        acc = torch.einsum("kijh,kjhf->ihf", p, hb[cols].double())
        out[br] = acc / torch.clamp(li, min=1e-16)[..., None]
        m[br], l[br] = mi, li.float()
    return out.reshape(n_pad, H * F), m.reshape(n_pad, H), l.reshape(n_pad, H)


def gat_bwd_row_plain(bsr, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                      feat: int, slope: float = 0.2):
    """-> ``df1 [n_pad, H]``: sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij."""
    B, n_pad = _geometry(bsr)
    H, F = num_heads, feat
    f1b, f2b = f1p.reshape(-1, B, H), f2p.reshape(-1, B, H)
    mb, lb, db = m.reshape(-1, B, H), l.reshape(-1, B, H), d.reshape(-1, B, H)
    hb, gb = hp.reshape(-1, B, H, F), gp.reshape(-1, B, H, F)
    df1 = torch.zeros(n_pad // B, B, H, dtype=torch.float32, device=hp.device)
    for br in range(n_pad // B):
        sel, cols = _row_blocks(bsr, br)
        if cols.numel() == 0:
            continue
        mask = (bsr.blocks[sel] > 0)[..., None]
        pre = f1b[br][None, :, None, :] + f2b[cols][:, None]
        alpha, dleaky = _alpha(mask, pre, mb[br][None, :, None, :],
                               lb[br][None, :, None, :], slope)
        gh = torch.einsum("ihf,kjhf->kijh", gb[br], hb[cols])
        dpre = alpha * (gh - db[br][None, :, None, :]) * dleaky
        df1[br] = dpre.sum(dim=(0, 2))
    return df1.reshape(n_pad, H)


def gat_bwd_col_plain(bsr, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                      feat: int, slope: float = 0.2):
    """-> ``(dh [n_pad, H*F], df2 [n_pad, H])`` over the blocks in
    column-major order: dh_j = sum_i alpha_ij g_i and
    df2_j = sum_i alpha_ij (g_i . h_j - D_i) leaky'_ij."""
    B, n_pad = _geometry(bsr)
    H, F = num_heads, feat
    f1b, f2b = f1p.reshape(-1, B, H), f2p.reshape(-1, B, H)
    mb, lb, db = m.reshape(-1, B, H), l.reshape(-1, B, H), d.reshape(-1, B, H)
    hb, gb = hp.reshape(-1, B, H, F), gp.reshape(-1, B, H, F)
    dh = torch.zeros(n_pad // B, B, H, F, dtype=torch.float32,
                     device=hp.device)
    df2 = torch.zeros(n_pad // B, B, H, dtype=torch.float32, device=hp.device)
    for bc in range(n_pad // B):
        idx, rows = _col_blocks(bsr, bc)
        if idx.numel() == 0:
            continue
        mask = (bsr.blocks[idx] > 0)[..., None]
        pre = f1b[rows][:, :, None, :] + f2b[bc][None, None]
        alpha, dleaky = _alpha(mask, pre, mb[rows][:, :, None, :],
                               lb[rows][:, :, None, :], slope)
        dh[bc] = torch.einsum("kijh,kihf->jhf", alpha, gb[rows])
        gh = torch.einsum("kihf,jhf->kijh", gb[rows], hb[bc])
        dpre = alpha * (gh - db[rows][:, :, None, :]) * dleaky
        df2[bc] = dpre.sum(dim=(0, 1))
    return dh.reshape(n_pad, H * F), df2.reshape(n_pad, H)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check(name, bsr, num_heads, feat, **tensors):
    """The kernel's contract, checked before a launch; raises ValueError."""
    B, n_pad = _geometry(bsr)
    H, F = num_heads, feat
    if H < 1 or F < 1 or H * F > MAX_HF:
        raise ValueError(f"{name}: H*F = {H}*{F} is outside the kernel's "
                         f"limit 1..{MAX_HF}")
    if B % 32:
        raise ValueError(f"{name}: block size {B} is not a multiple of 32")
    if bsr.blocks.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel reads an f32 mask, not "
                         f"{bsr.blocks.dtype}")
    widths = {"f1": H, "f2": H, "h": H * F, "g": H * F, "m": H, "l": H,
              "d": H}
    device = bsr.blocks.device
    for key, t in tensors.items():
        if t.shape != (n_pad, widths[key]) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 "
                             f"[{n_pad}, {widths[key]}], not {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in [bsr.blocks, bsr.row_ptr, bsr.block_cols, bsr.block_rows,
              bsr.colmajor_order, bsr.col_ptr, *tensors.values()]:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             f"{device}")
    return B, n_pad


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(name, t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def gat_fwd_stats(bsr, f1p, f2p, hp, *, num_heads: int, feat: int,
                  slope: float = 0.2):
    """Forward with stats on padded operands -> ``(out, m, l)``. A CPU
    tensor takes :func:`gat_fwd_stats_plain`; a CUDA tensor launches
    ``h2gcn_gat_fwd`` or raises."""
    if not _on_cuda("gat_fwd_stats", hp):
        return gat_fwd_stats_plain(bsr, f1p, f2p, hp, num_heads=num_heads,
                                   feat=feat, slope=slope)
    B, n_pad = _check("gat_fwd_stats", bsr, num_heads, feat, f1=f1p, f2=f2p,
                      h=hp)
    out = torch.empty(n_pad, num_heads * feat, dtype=torch.float32,
                      device=hp.device)
    m = torch.empty(n_pad, num_heads, dtype=torch.float32, device=hp.device)
    l = torch.empty_like(m)
    lib, _ = _build.library()
    err = lib.h2gcn_gat_fwd(
        bsr.row_ptr.data_ptr(), bsr.block_cols.data_ptr(),
        bsr.blocks.data_ptr(), f1p.data_ptr(), f2p.data_ptr(), hp.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), n_pad, B, num_heads,
        feat, slope, _stream(hp))
    _build.check(lib, err, "gat_fwd_stats")
    gat_fwd_stats.launches += 1
    return out, m, l


def gat_bwd_row(bsr, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                feat: int, slope: float = 0.2):
    """Row backward pass on padded operands -> ``df1``. A CPU tensor takes
    :func:`gat_bwd_row_plain`; a CUDA tensor launches
    ``h2gcn_gat_bwd_row`` or raises."""
    if not _on_cuda("gat_bwd_row", hp):
        return gat_bwd_row_plain(bsr, f1p, f2p, hp, gp, m, l, d,
                                 num_heads=num_heads, feat=feat, slope=slope)
    B, n_pad = _check("gat_bwd_row", bsr, num_heads, feat, f1=f1p, f2=f2p,
                      h=hp, g=gp, m=m, l=l, d=d)
    df1 = torch.empty(n_pad, num_heads, dtype=torch.float32,
                      device=hp.device)
    lib, _ = _build.library()
    err = lib.h2gcn_gat_bwd_row(
        bsr.row_ptr.data_ptr(), bsr.block_cols.data_ptr(),
        bsr.blocks.data_ptr(), f1p.data_ptr(), f2p.data_ptr(), hp.data_ptr(),
        gp.data_ptr(), m.data_ptr(), l.data_ptr(), d.data_ptr(),
        df1.data_ptr(), n_pad, B, num_heads, feat, slope, _stream(hp))
    _build.check(lib, err, "gat_bwd_row")
    gat_bwd_row.launches += 1
    return df1


def gat_bwd_col(bsr, f1p, f2p, hp, gp, m, l, d, *, num_heads: int,
                feat: int, slope: float = 0.2):
    """Column backward pass on padded operands -> ``(dh, df2)``. A CPU
    tensor takes :func:`gat_bwd_col_plain`; a CUDA tensor launches
    ``h2gcn_gat_bwd_col`` or raises."""
    if not _on_cuda("gat_bwd_col", hp):
        return gat_bwd_col_plain(bsr, f1p, f2p, hp, gp, m, l, d,
                                 num_heads=num_heads, feat=feat, slope=slope)
    B, n_pad = _check("gat_bwd_col", bsr, num_heads, feat, f1=f1p, f2=f2p,
                      h=hp, g=gp, m=m, l=l, d=d)
    dh = torch.empty(n_pad, num_heads * feat, dtype=torch.float32,
                     device=hp.device)
    df2 = torch.empty(n_pad, num_heads, dtype=torch.float32,
                      device=hp.device)
    lib, _ = _build.library()
    err = lib.h2gcn_gat_bwd_col(
        bsr.col_ptr.data_ptr(), bsr.colmajor_order.data_ptr(),
        bsr.block_rows.data_ptr(), bsr.blocks.data_ptr(), f1p.data_ptr(),
        f2p.data_ptr(), hp.data_ptr(), gp.data_ptr(), m.data_ptr(),
        l.data_ptr(), d.data_ptr(), dh.data_ptr(), df2.data_ptr(), n_pad, B,
        num_heads, feat, slope, _stream(hp))
    _build.check(lib, err, "gat_bwd_col")
    gat_bwd_col.launches += 1
    return dh, df2


# kernel launches; chip_smoke.py reads them
gat_fwd_stats.launches = 0
gat_bwd_row.launches = 0
gat_bwd_col.launches = 0


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def head_dots(gp: torch.Tensor, out: torch.Tensor, num_heads: int,
              feat: int) -> torch.Tensor:
    """``D [n, H]``: per head, the dot product of ``g`` and ``out`` rows."""
    n = gp.shape[0]
    return (gp.reshape(n, num_heads, feat)
            * out.reshape(n, num_heads, feat)).sum(dim=2)


def bsr_gat_attention(bsr, f1, f2, h, *, num_heads: int, feat: int,
                      n_out: int, slope: float = 0.2) -> torch.Tensor:
    """Fused attention over the BSR mask, forward only: ``[n_out, H*F]``."""
    _, n_pad = _geometry(bsr)
    out, _, _ = gat_fwd_stats(bsr, pad_rows(f1, n_pad), pad_rows(f2, n_pad),
                              pad_rows(h, n_pad), num_heads=num_heads,
                              feat=feat, slope=slope)
    return out[:n_out]


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, h, bsr, num_heads, feat, n_out, slope):
        _, n_pad = _geometry(bsr)
        f1p, f2p, hp = (pad_rows(t, n_pad) for t in (f1, f2, h))
        out, m, l = gat_fwd_stats(bsr, f1p, f2p, hp, num_heads=num_heads,
                                  feat=feat, slope=slope)
        ctx.save_for_backward(f1p, f2p, hp, out, m, l)
        ctx.conf = (bsr, num_heads, feat, n_out, slope,
                    f1.shape[0], f2.shape[0], h.shape[0])
        return out[:n_out]

    @staticmethod
    def backward(ctx, g):
        f1p, f2p, hp, out, m, l = ctx.saved_tensors
        bsr, num_heads, feat, n_out, slope, n1, n2, nh = ctx.conf
        gp = pad_rows(g, out.shape[0])
        d = head_dots(gp, out, num_heads, feat)
        kw = dict(num_heads=num_heads, feat=feat, slope=slope)
        df1 = gat_bwd_row(bsr, f1p, f2p, hp, gp, m, l, d, **kw)
        dh, df2 = gat_bwd_col(bsr, f1p, f2p, hp, gp, m, l, d, **kw)
        return df1[:n1], df2[:n2], dh[:nh], None, None, None, None, None


def gat_attention(bsr, f1, f2, h, *, num_heads: int, feat: int, n_out: int,
                  slope: float = 0.2) -> torch.Tensor:
    """Differentiable fused attention: :func:`bsr_gat_attention` with
    gradients in ``f1``, ``f2`` and ``h`` through the row and column
    backward kernels."""
    return _GATAttention.apply(f1, f2, h, bsr, num_heads, feat, n_out, slope)

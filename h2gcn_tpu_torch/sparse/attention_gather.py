"""Gather-formulated fused graph attention: host tables, the weighted
combine kernel's wrapper and its plain PyTorch version, and the
differentiable attention over them.

The port of ``h2gcn_tpu/sparse/pallas_attention_gather.py``. The attention
splits at the boundary the SpMM ladder has:

- **edge-major SDDMM and softmax terms**, plain PyTorch index ops over the
  edge list (``_edge_terms``): the logit ``s_e = f1[row_e] + f2[col_e]``,
  the shifted weight ``p_e`` and its liveness;
- **the combine** ``out_i = sum_e w_e x[col_e]``: a gather-scatter SpMM with
  per-edge, per-head weights, :func:`gscatter_weighted`, which launches
  ``csrc/gscatter_weighted.cu`` over the gscatter tables of
  :func:`~.gscatter.build_gscatter_coo` in both orientations, one thread
  block per work item that :func:`~.gscatter.build_schedule` cuts from
  each segment's chunks (kept beside the tables, so a heavy stripe is
  spread over many blocks).

The whole attention is one ``torch.autograd.Function``
(:func:`gather_attention`), and no direction runs a segment reduction: the
forward's softmax denominator comes out of an augmented combine (a ones
column a head), and the backward's three edge reductions factor per
destination or source row into three more combines (dh plain over the
transpose tables, df1 and df2 augmented). Because alpha materializes per
edge, attention dropout (an explicit mask) and coefficient capture
(:func:`gather_attention_coefficients`) work on this payload.

The softmax shift is the JAX package's upper bound
``b_i = LeakyReLU(f1_i + max_j f2_j)`` (per head; LeakyReLU is monotone),
not the row max: softmax is invariant to a per-row shift, ``p = exp(s - b)
<= 1`` never overflows, and no segment max is needed. An edge more than
60 below its bound is clamped (its weight ~exp(-60)), as in the JAX
package; that needs a per-row logit spread past 60.

Precision: ``"highest"`` gathers f32 rows; ``"default"`` gathers them in
bf16. The weights and every product and sum stay f32 (the JAX package also
rounds the weighted product to bf16).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from . import _build
from .attention import _leaky
from .gscatter import (_MAX_SHARED, GScatter, _operand, build_gscatter_coo,
                       build_schedule, chunk_budget)

# the combine kernel's warps a thread block, and the table tile of
# build_gatherattn: the fastest of 16 and 32 warps x tile 128 and 512 for
# the 10K graph's layer-1 combines on the H100 (PERF.md, section 6); the
# tables of the JAX package's default tile (512) are the same function
COMBINE_WARPS = 16
GATHER_TILE = 128
# streaming multiprocessors the work items are cut for when the tables are
# built off the card (the H100's)
_SMS = 132


@dataclasses.dataclass
class GatherAttn:
    """Fused-attention payload: gscatter tables in both orientations, the
    edge list in CSR order and the edge <-> slot maps.

    ``fwd`` groups edges by destination stripe of ``tile`` rows (forward
    combine, df1), ``bwd`` the same edges by source stripe (dh, df2).
    ``slot2edge_*[s]`` is the edge of global slot ``s`` (``num_edges`` for
    a padding slot). ``items_*`` holds, per segment of ``fwd`` / ``bwd``,
    the combine kernel's work items ``(item_ptr, item_stripe)``
    (:func:`combine_items`). ``n_src`` is the source count of a rectangular
    support (0: square)."""

    fwd: GScatter
    bwd: GScatter
    rows: torch.Tensor          # [E] int64 destination node per edge
    cols: torch.Tensor          # [E] int64 source node per edge
    slot_fwd: torch.Tensor      # [E] int64 global slot of each edge
    slot_bwd: torch.Tensor      # [E] int64
    slot2edge_fwd: torch.Tensor  # [total_slots_fwd] int32
    slot2edge_bwd: torch.Tensor  # [total_slots_bwd] int32
    items_fwd: tuple = ()       # per fwd segment (item_ptr, item_stripe)
    items_bwd: tuple = ()       # per bwd segment
    n: int = 0
    num_edges: int = 0
    n_src: int = 0

    @property
    def num_src(self) -> int:
        return self.n_src or self.n

    @property
    def total_slots_fwd(self) -> int:
        return max(s.slot_hi for s in self.fwd.segments)

    @property
    def total_slots_bwd(self) -> int:
        return max(s.slot_hi for s in self.bwd.segments)


def combine_items(gs: GScatter, sms: int = _SMS) -> tuple:
    """The combine kernel's work items over each segment of ``gs``:
    ``(item_ptr, item_stripe)`` int32 tensors on the tables' device, cut
    by :func:`~.gscatter.build_schedule` at B1's chunk budget for ``sms``
    SMs (the widths the attention combines take one column tile)."""
    items = []
    for seg in gs.segments:
        ptr = seg.chunk_ptr.cpu().numpy()
        item_ptr, item_stripe = build_schedule(
            ptr, chunk_budget(int(ptr[-1]), gs.e_b, sms))
        dev = seg.chunk_ptr.device
        items.append((torch.from_numpy(item_ptr).to(dev),
                      torch.from_numpy(item_stripe).to(dev)))
    return tuple(items)


def combine_width(tile: int, f: int) -> int:
    """Columns one combine thread block takes: 32 a lane-column, as many
    (at most 4) as cover ``f``, fewer where ``tile`` rows of them would
    not fit in shared memory."""
    v = min(4, max(1, -(-f // 32)))
    while v > 1 and tile * 32 * v * 4 > _MAX_SHARED:
        v -= 1
    return 32 * v


def build_gatherattn(csr, tile: int = GATHER_TILE, e_b: int = 128,
                     kb: int = 8, device="cpu") -> GatherAttn:
    """Host prep from the attention support (any stored entry is an edge;
    values are ignored). A rectangular support (n destination rows x m
    source rows) indexes f1 over destinations and f2, h over sources. The
    combine's work items are cut for ``device``'s SMs (off the card, for
    the H100's)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(csr)
    n, m = csr.shape
    coo = csr.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    ones = np.ones(len(r), np.float32)
    gs_f, slot_f = build_gscatter_coo(r, c, ones, (n, m), tile=tile, e_b=e_b,
                                      kb=kb, return_slots=True, device=device)
    gs_b, slot_b = build_gscatter_coo(c, r, ones, (m, n), tile=tile, e_b=e_b,
                                      kb=kb, return_slots=True, device=device)
    E = len(r)

    def inv(slots, gs):
        total = max(s.slot_hi for s in gs.segments)
        s2e = np.full(total, E, np.int32)  # padding -> weight 0
        s2e[slots] = np.arange(E, dtype=np.int32)
        return torch.from_numpy(s2e).to(device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    device = torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else _SMS)
    return GatherAttn(
        fwd=gs_f, bwd=gs_b, rows=dev(r), cols=dev(c),
        slot_fwd=dev(slot_f), slot_bwd=dev(slot_b),
        slot2edge_fwd=inv(slot_f, gs_f), slot2edge_bwd=inv(slot_b, gs_b),
        items_fwd=combine_items(gs_f, sms), items_bwd=combine_items(gs_b, sms),
        n=n, num_edges=E, n_src=0 if m == n else m)


# ---------------------------------------------------------------------------
# The weighted combine: plain PyTorch version and kernel wrapper.
# ---------------------------------------------------------------------------


def _column_weights(seg, slot2edge, wf, wl, fw):
    """Per slot of ``seg`` and column of x, its weight [slots, H * fw]:
    the edge's weight of the column's head (0 for a padding slot); with
    ``wl``, the last column of each head block takes ``wl``."""
    E, H = wf.shape
    nslots = seg.vals.numel()
    edge = torch.full((nslots,), E, dtype=torch.int64, device=wf.device)
    edge[:seg.slot_hi - seg.slot_lo] = slot2edge[seg.slot_lo:seg.slot_hi]
    zero = torch.zeros(1, H, dtype=wf.dtype, device=wf.device)
    w = torch.cat([wf, zero])[edge][:, :, None].expand(-1, -1, fw).clone()
    if wl is not None:
        w[:, :, fw - 1] = torch.cat([wl, zero])[edge]
    return w.reshape(nslots, H * fw) * seg.vals.reshape(-1, 1)


def gscatter_weighted_plain(gs: GScatter, slot2edge, wf, x, *,
                            num_heads: int, wl=None,
                            precision: str = "highest") -> torch.Tensor:
    """The plain PyTorch version: the tables expanded to slots, weights
    filled through ``slot2edge``, then ``index_add_``. ``x`` [m, H * fw]
    -> [n, H * fw] float32."""
    xk = _operand(x, precision).to(torch.float32)
    f = xk.shape[1]
    n_pad = (-(-gs.n_rows // gs.tile)) * gs.tile
    out = torch.zeros(n_pad, f, dtype=torch.float32, device=xk.device)
    for seg in gs.segments:
        stripe = seg.ctr.to(torch.int64).repeat_interleave(gs.kb) + seg.rb_lo
        dest = (stripe[:, None] * gs.tile + seg.rows).reshape(-1)
        w = _column_weights(seg, slot2edge, wf.float(),
                            None if wl is None else wl.float(), f // num_heads)
        out.index_add_(0, dest, xk[seg.cols.to(torch.int64)] * w)
    return out[:gs.n_rows]


def gscatter_weighted(gs: GScatter, slot2edge, wf, x, *, num_heads: int,
                      wl=None, precision: str = "highest", items=None,
                      warps: int = COMBINE_WARPS) -> torch.Tensor:
    """``A_w @ x`` over gather tables: edge ``e`` (slot ``s`` with
    ``slot2edge[s] = e``) weighs column ``c`` of its source row by
    ``wf[e, c // fw]`` (``fw = x.shape[1] / num_heads``), or with ``wl``
    its head's last column by ``wl[e, c // fw]``. A CPU tensor takes
    :func:`gscatter_weighted_plain`; a CUDA tensor launches
    ``h2gcn_gscatter_weighted`` (once per segment, over the segment's work
    ``items`` from :class:`GatherAttn`, ``warps`` warps a block, into one
    zeroed output) or raises."""
    kw = dict(num_heads=num_heads, wl=wl, precision=precision)
    if x.device.type == "cpu":
        return gscatter_weighted_plain(gs, slot2edge, wf, x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"gscatter_weighted: unsupported device {x.device}")
    H = num_heads
    if x.dim() != 2 or x.shape[0] != gs.n_cols or x.shape[1] % H:
        raise ValueError(f"gscatter_weighted: x {tuple(x.shape)} does not "
                         f"match A [{gs.n_rows}, {gs.n_cols}] with {H} heads")
    if gs.overflow:
        raise ValueError("gscatter_weighted: tables with overflow levels "
                         "have no edge -> slot map")
    if items is None or len(items) != len(gs.segments):
        raise ValueError("gscatter_weighted: needs the work items of each "
                         "segment (GatherAttn.items_fwd / items_bwd)")
    E = wf.shape[0]
    for name, w in (("wf", wf), ("wl", wl)):
        if w is not None and (w.shape != (E, H) or w.dtype != torch.float32
                              or not w.is_contiguous()):
            raise ValueError(f"gscatter_weighted: {name} must be contiguous "
                             f"float32 [{E}, {H}], not {w.dtype} "
                             f"{tuple(w.shape)}")
    xk = _operand(x, precision).contiguous()
    f = xk.shape[1]
    out = torch.zeros(gs.n_rows, f, dtype=torch.float32, device=xk.device)
    if f == 0 or gs.n_rows == 0:
        return out
    width = combine_width(gs.tile, f)
    if gs.tile * width * 4 > _MAX_SHARED:
        raise ValueError(f"gscatter_weighted: tile {gs.tile} does not fit "
                         "the kernel's shared stripe")
    for t in [slot2edge, wf, wl] + [u for seg, its in zip(gs.segments, items)
                                    for u in (seg.chunk_ptr, seg.rows,
                                              seg.cols, seg.vals) + its]:
        if t is not None and (t.device != xk.device or not t.is_contiguous()):
            raise ValueError("gscatter_weighted: tensors must be contiguous "
                             f"and on {xk.device}")
    lib, _ = _build.library()
    stream = torch.cuda.current_stream(xk.device).cuda_stream
    for seg, (item_ptr, item_stripe) in zip(gs.segments, items):
        err = lib.h2gcn_gscatter_weighted(
            item_ptr.data_ptr(), item_stripe.data_ptr(),
            int(item_stripe.shape[0]), seg.chunk_ptr.data_ptr(),
            seg.rows.data_ptr(), seg.cols.data_ptr(), seg.vals.data_ptr(),
            slot2edge.data_ptr(), seg.slot_lo, seg.slot_hi - seg.slot_lo, E,
            wf.data_ptr(), None if wl is None else wl.data_ptr(), H, f // H,
            xk.data_ptr(), int(xk.dtype == torch.bfloat16), out.data_ptr(),
            seg.rb_lo, gs.tile, gs.e_b, gs.n_rows, f, width // 32, warps,
            stream)
        _build.check(lib, err, "gscatter_weighted")
        tracing.launched("gscatter_weighted")
    return out


# ---------------------------------------------------------------------------
# The attention.
# ---------------------------------------------------------------------------


def _edge_terms(ga: GatherAttn, f1, f2, slope):
    """``(s, p, live)`` [E, H]: the pre-activation logit, the weight
    exp(LeakyReLU(s) - b) under the upper-bound shift b, clamped at
    exp(-60), and whether the edge lies within 60 of its bound."""
    f1f, f2f = f1.float(), f2.float()
    s = f1f[ga.rows] + f2f[ga.cols]
    b = _leaky(f1f + f2f.max(dim=0, keepdim=True).values, slope)
    z = _leaky(s, slope) - b[ga.rows]
    live = z > -60.0  # f32-underflow guard
    return s, torch.exp(torch.clamp(z, min=-60.0)), live


def _augx(x, xb, num_heads: int, feat: int):
    """[n, H * F] features and [n, H] extra columns -> [n, H * (F + 1)],
    each head's block followed by its extra column."""
    n = x.shape[0]
    return torch.cat([x.float().reshape(n, num_heads, feat),
                      xb.float()[:, :, None]], dim=2).reshape(
                          n, num_heads * (feat + 1))


class _GatherAttention(torch.autograd.Function):
    @staticmethod
    @tracing.traced("attn.forward")
    def forward(ctx, f1, f2, h, m, ga, num_heads, feat, slope, precision):
        H, F = num_heads, feat
        _, p, _ = _edge_terms(ga, f1, f2, slope)
        # numerator weights p * m (attention dropout), denominator p
        awf = p if m is None else (p * m).contiguous()
        ones = torch.ones(h.shape[0], H, dtype=torch.float32, device=h.device)
        oa = gscatter_weighted(ga.fwd, ga.slot2edge_fwd, awf,
                               _augx(h, ones, H, F), num_heads=H, wl=p,
                               precision=precision, items=ga.items_fwd)
        oa = oa.reshape(-1, H, F + 1)
        l = oa[..., F]
        lhat = torch.where(l == 0, 1.0, l)
        out = (oa[..., :F] / lhat[..., None]).reshape(-1, H * F)
        ctx.save_for_backward(f1, f2, h, m, l, out)
        ctx.conf = (ga, H, F, slope, precision)
        return out

    @staticmethod
    @tracing.traced("attn.backward")
    def backward(ctx, G):
        f1, f2, h, m, l, out = ctx.saved_tensors
        ga, H, F, slope, precision = ctx.conf
        G = G.float()
        lhat = torch.where(l == 0, 1.0, l)
        G3 = G.reshape(-1, H, F)
        gN = (G3 / lhat[..., None]).reshape(-1, H * F)
        gl = -(G3 * out.reshape(-1, H, F)).sum(dim=-1) / lhat
        s, p, live = _edge_terms(ga, f1, f2, slope)
        # ds_e = leaky'(s_e) p_e (m_e gN[r_e] . h[c_e] + gl[r_e]) factors per
        # destination and source row into three combines
        q = torch.where(s >= 0, 1.0, slope) * torch.where(live, p, 0.0)
        qm = q if m is None else (q * m).contiguous()
        pm = p if m is None else (p * m).contiguous()
        kw = dict(num_heads=H, precision=precision)
        dh = gscatter_weighted(ga.bwd, ga.slot2edge_bwd, pm, gN,
                               items=ga.items_bwd, **kw)
        ones = torch.ones(h.shape[0], H, dtype=torch.float32, device=h.device)
        nt = gscatter_weighted(ga.fwd, ga.slot2edge_fwd, qm,
                               _augx(h, ones, H, F), wl=q,
                               items=ga.items_fwd, **kw)
        nt3 = nt.reshape(-1, H, F + 1)
        df1 = (gN.reshape(-1, H, F) * nt3[..., :F]).sum(dim=-1) + gl * nt3[..., F]
        tt = gscatter_weighted(ga.bwd, ga.slot2edge_bwd, qm,
                               _augx(gN, gl, H, F), wl=q,
                               items=ga.items_bwd, **kw)
        tt3 = tt.reshape(-1, H, F + 1)
        df2 = (h.float().reshape(-1, H, F) * tt3[..., :F]).sum(dim=-1) + tt3[..., F]
        return (df1.to(f1.dtype), df2.to(f2.dtype), dh.to(h.dtype),
                None, None, None, None, None, None)


def gather_attention(ga: GatherAttn, f1, f2, h, m=None, *, num_heads: int,
                     feat: int, slope: float = 0.2,
                     precision: str = "highest") -> torch.Tensor:
    """Differentiable attention ``(f1, f2, h, m) -> out [n, H * F]`` over
    the gather payload. ``m`` [E, H] is the attention-dropout mask on the
    coefficients (the numerator's weights; None: no dropout); it gets no
    gradient. ``f1: [n, H]``, ``f2: [m, H]``, ``h: [m, H * F]``."""
    if m is not None:
        m = m.to(torch.float32).contiguous()
    return _GatherAttention.apply(f1, f2, h, m, ga, num_heads, feat, slope,
                                  precision)


def gat_attention_gather(ga: GatherAttn, f1, f2, h, *, num_heads: int,
                         feat: int, n_out: int, slope: float = 0.2,
                         precision: str = "highest", attn_drop: float = 0.0,
                         generator=None) -> torch.Tensor:
    """Fused multi-head attention, gather formulation: the contract of
    :func:`~.attention_coo.gat_attention_coo` plus attention-coefficient
    dropout at rate ``attn_drop``, its [E, H] mask drawn from
    ``generator`` (no dropout without one)."""
    m = None
    if attn_drop and generator is not None:
        keep = 1.0 - attn_drop
        m = torch.where(
            torch.rand((ga.num_edges, num_heads), generator=generator,
                       device=f1.device) < keep, 1.0 / keep, 0.0)
    return gather_attention(ga, f1, f2, h, m, num_heads=num_heads, feat=feat,
                            slope=slope, precision=precision)[:n_out]


class _GatherCombine(torch.autograd.Function):
    @staticmethod
    @tracing.traced("attn.forward")
    def forward(ctx, alpha, h, ga, num_heads, feat, precision):
        ctx.save_for_backward(alpha, h)
        ctx.conf = (ga, num_heads, feat, precision)
        return gscatter_weighted(ga.fwd, ga.slot2edge_fwd,
                                 alpha.float().contiguous(), h,
                                 num_heads=num_heads, precision=precision,
                                 items=ga.items_fwd)

    @staticmethod
    @tracing.traced("attn.backward")
    def backward(ctx, g):
        alpha, h = ctx.saved_tensors
        ga, H, F, precision = ctx.conf
        gf = g.float()
        # dh = (A_alpha)^T g over the transpose tables
        dh = gscatter_weighted(ga.bwd, ga.slot2edge_bwd,
                               alpha.float().contiguous(), gf, num_heads=H,
                               precision=precision, items=ga.items_bwd)
        # dalpha_e = g[row_e] . h[col_e] per head: an edge-major SDDMM
        dalpha = (gf[ga.rows] * h.float()[ga.cols]).reshape(
            ga.num_edges, H, F).sum(dim=-1)
        return dalpha.to(alpha.dtype), dh.to(h.dtype), None, None, None, None


def gather_combine(ga: GatherAttn, alpha, h, *, num_heads: int, feat: int,
                   precision: str = "highest") -> torch.Tensor:
    """Differentiable combine ``out [n, H * F] = sum_e alpha[e, k] h[col_e]``
    from per-edge weights ``alpha [E, H]`` (CSR edge order) and projected
    features ``h [m, H * F]``."""
    return _GatherCombine.apply(alpha, h, ga, num_heads, feat, precision)


def gather_attention_coefficients(ga: GatherAttn, f1, f2, *,
                                  slope: float = 0.2) -> torch.Tensor:
    """Per-edge softmaxed attention coefficients [E, H] in CSR edge order:
    the segment path's captured alpha, available on this payload because
    the coefficients exist per edge."""
    logit = _leaky(f1.float()[ga.rows] + f2.float()[ga.cols], slope)
    H = logit.shape[1]
    idx = ga.rows[:, None].expand(-1, H)
    m = torch.full((ga.n, H), -torch.inf, dtype=torch.float32,
                   device=logit.device).scatter_reduce(
                       0, idx, logit, reduce="amax", include_self=True)
    p = torch.exp(logit - m[ga.rows])
    l = torch.zeros(ga.n, H, dtype=torch.float32,
                    device=logit.device).index_add_(0, ga.rows, p)
    return p / l[ga.rows]

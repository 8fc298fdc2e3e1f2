"""GAT / SpGAT baseline (Veličković et al., ICLR 2018).

The port of ``h2gcn_tpu.models.GAT``. Reference semantics
(baselines/GAT/):

* sparse attention head (utils/layers.py:53-100): ``h = XW``; per-edge
  logit ``leakyrelu(a₁ᵀh_i + b₁ + a₂ᵀh_j + b₂)`` over the self-looped
  adjacency; per-destination softmax; attention dropout; ``Σ α_ij h_j +
  bias`` then ELU;
* 8 concatenated heads of width 8 in layer 1, 1 averaged head at the
  output (execute_cora_sparse.py:18-19);
* Adam lr 0.005, L2 ``5e-4·Σ½‖θ‖²`` over all weights (base_gattn.py:12-26),
  input/attention dropout 0.6, patience-100 early stopping tracking both
  best val acc and best val loss (execute_cora_sparse.py:200-230).

Two paths compute a layer. The segment path gathers per-edge logits and
reduces them by destination (``scatter_reduce`` and ``index_add_``); it
expresses attention dropout and coefficient capture. The fused path
(``--fused_attention``) runs all heads of a layer through the payload that
:func:`build_gat_adjacency` chose: the BSR mask kernels
(:func:`~h2gcn_tpu_torch.sparse.attention.gat_attention`), or past the BSR
budget the gather payload
(:func:`~h2gcn_tpu_torch.sparse.attention_gather.gat_attention_gather`) or
the COO-chunk kernels
(:func:`~h2gcn_tpu_torch.sparse.attention_coo.gat_attention_coo`). The BSR
and COO-chunk kernels never materialize the coefficients, so with them the
fused path runs only without attention dropout (or in eval) and without
capture; the gather payload takes both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..nn.metrics import masked_softmax_cross_entropy
from ..nn.ops import dropout
from ..sparse import SparseMatrix, transforms
from ..sparse.attention import gat_attention
from ..sparse.attention_coo import gat_attention_coo
from ..sparse.attention_gather import (GATHER_TILE, GatherAttn,
                                       gat_attention_gather,
                                       gather_attention_coefficients)
from . import _runtime

def segment_softmax(logits, segment_ids, num_segments, valid):
    """Numerically stable softmax over edges grouped by destination row.

    The row max only shifts the logits, so it is taken without a gradient
    (the softmax's gradient in it is zero)."""
    logits = torch.where(valid, logits, -math.inf)
    seg_max = torch.full((num_segments,), -math.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, segment_ids, logits.detach(),
                                     reduce="amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(valid, torch.exp(logits - seg_max[segment_ids]), 0.0)
    denom = torch.zeros(num_segments, dtype=ex.dtype,
                        device=ex.device).index_add(0, segment_ids, ex)
    return ex / torch.clamp(denom[segment_ids], min=1e-16)


def _glorot(shape, generator):
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(*shape, generator=generator) * 2 - 1) * limit


class GATNetwork(nn.Module):
    """Multi-head graph attention with the port's runtime interface.

    Parameters live in ``layers[li][hi]``, one ``ParameterDict`` a head
    with the JAX package's names (``W``, ``a1``, ``a2``, ``b1``, ``b2``,
    ``bias`` and, for a residual between unequal widths, ``Wres``,
    ``bres``). Call :meth:`init` once before the first forward.
    """

    def __init__(self, num_classes, *, hid_units=(8,), n_heads=(8, 1),
                 in_drop=0.6, attn_drop=0.6, residual=False, l2_coef=5e-4,
                 fused_attention=False, fused_precision="highest"):
        super().__init__()
        self.num_classes = num_classes
        self.fused_attention = fused_attention
        # "highest": f32 head contractions; "default": bf16 operands with
        # f32 sums. The gather and COO-chunk payloads take it; the BSR
        # kernels always run in f32, as in the JAX package
        self.fused_precision = fused_precision
        self.hid_units = list(hid_units)
        self.n_heads = list(n_heads)
        self.in_drop = in_drop
        self.attn_drop = attn_drop
        self.residual = residual
        self.l2_coef = l2_coef
        self.last_attn_coefs = None
        self.layers = nn.ModuleList()

    def init(self, input_dim: int, num_hops: int, generator: torch.Generator,
             device="cpu") -> "GATNetwork":
        """Glorot-uniform ``W``, ``a1``, ``a2`` (and ``Wres``) drawn from
        ``generator`` head by head, zero biases; then move to ``device``."""
        dims = [input_dim] + [h * k for h, k in
                              zip(self.hid_units, self.n_heads[:-1])]
        out_dims = self.hid_units + [self.num_classes]
        n_layers = len(out_dims)
        self.layers = nn.ModuleList()
        for li, (din, dout) in enumerate(zip(dims, out_dims)):
            heads = nn.ModuleList()
            for _ in range(self.n_heads[li] if li < len(self.n_heads) else 1):
                p = {
                    "W": _glorot((din, dout), generator),
                    "a1": _glorot((dout, 1), generator)[:, 0],
                    "a2": _glorot((dout, 1), generator)[:, 0],
                    "b1": torch.zeros(()),
                    "b2": torch.zeros(()),
                    "bias": torch.zeros(dout),
                }
                if self.residual and li < n_layers - 1 and din != dout:
                    # learned 1x1 projection for the residual when dims
                    # differ (reference utils/layers.py:94-99 conv1d)
                    p["Wres"] = _glorot((din, dout), generator)
                    p["bres"] = torch.zeros(dout)
                heads.append(nn.ParameterDict(
                    {k: nn.Parameter(v.contiguous()) for k, v in p.items()}))
            self.layers.append(heads)
        return self.to(device)

    # ------------------------------------------------------------ one head
    def _logits(self, p, x):
        h = torch.matmul(x, p["W"])
        return h, h @ p["a1"] + p["b1"], h @ p["a2"] + p["b2"]

    def _residual(self, p, xd, out):
        # pre-activation residual (reference utils/layers.py:94-99); uses
        # the post-input-dropout x, as the reference reassigns seq
        if "Wres" in p:
            return out + torch.matmul(xd, p["Wres"]) + p["bres"]
        return out + xd

    def _attn_head(self, p, x, adj, *, training, generator,
                   capture_alpha=None, residual=False):
        rows = adj.rows.to(torch.int64)
        cols = adj.cols.to(torch.int64)
        edge_valid = adj.vals > 0  # padding entries carry value 0
        n = adj.shape[0]
        x = dropout(x, self.in_drop, generator, training=training)
        h, f1, f2 = self._logits(p, x)
        e = torch.nn.functional.leaky_relu(f1[rows] + f2[cols], 0.2)
        alpha = segment_softmax(e, rows, n, edge_valid)
        alpha = dropout(alpha, self.attn_drop, generator, training=training)
        h = dropout(h, self.in_drop, generator, training=training)
        out = torch.zeros(n, h.shape[1], dtype=h.dtype,
                          device=h.device).index_add(
                              0, rows, alpha[:, None] * h[cols])
        out = out + p["bias"]
        if residual:
            out = self._residual(p, x, out)
        if capture_alpha is not None:
            capture_alpha.append(alpha)
        return out

    def _fused_layer(self, heads, x, adj, *, training, generator,
                     residual=False, capture_alpha=None):
        """All heads of one layer through the fused attention payload."""
        h_parts, f1_parts, f2_parts, xd_parts = [], [], [], []
        for p in heads:
            # the dropout structure of the segment path: logits come from
            # the pre-dropout transform; only the aggregated features get
            # the second dropout
            xd = dropout(x, self.in_drop, generator, training=training)
            xd_parts.append(xd)
            hk, f1, f2 = self._logits(p, xd)
            f1_parts.append(f1)
            f2_parts.append(f2)
            h_parts.append(dropout(hk, self.in_drop, generator,
                                   training=training))
        feat = h_parts[0].shape[1]
        f1s, f2s = torch.stack(f1_parts, dim=1), torch.stack(f2_parts, dim=1)
        hs = torch.cat(h_parts, dim=1)
        kw = dict(num_heads=len(heads), feat=feat, n_out=x.shape[0])
        if isinstance(adj.attn, GatherAttn):
            # alpha materializes per edge here: one [E, H] coefficient
            # dropout mask a layer, drawn from the generator
            out = gat_attention_gather(
                adj.attn, f1s, f2s, hs, precision=self.fused_precision,
                attn_drop=self.attn_drop if training else 0.0,
                generator=generator, **kw)
            if capture_alpha is not None:
                # [E, H] -> [H, E], as the segment path's per-head stack
                capture_alpha.append(
                    gather_attention_coefficients(adj.attn, f1s, f2s).T)
        elif adj.attn is not None:
            out = gat_attention_coo(adj.attn, f1s, f2s, hs,
                                    precision=self.fused_precision, **kw)
        else:
            out = gat_attention(adj.bsr, f1s, f2s, hs, **kw)
        outs = []
        for k, p in enumerate(heads):
            o = out[:, k * feat:(k + 1) * feat] + p["bias"]
            if residual:
                o = self._residual(p, xd_parts[k], o)
            outs.append(o)
        return outs

    # ------------------------------------------------------------- forward
    def forward(self, adj: SparseMatrix, x: torch.Tensor, adjhops=(), *,
                training: bool = False, generator=None, capture=None):
        """Logits for every node. ``capture`` (a dict) receives each
        layer's output under ``activations/<li>-gat``, and the model keeps
        every layer's attention coefficients in ``last_attn_coefs``."""
        h = x
        n_layers = len(self.layers)
        # the fused payloads carry their own backward, so they train too;
        # attention dropout and coefficient capture need per-edge alpha,
        # which only the gather payload materializes
        attn = getattr(adj, "attn", None)
        is_gather = isinstance(attn, GatherAttn)
        use_fused = (
            self.fused_attention
            and (getattr(adj, "bsr", None) is not None or attn is not None)
            and (capture is None or is_gather)
            and (not training or self.attn_drop == 0 or is_gather)
        )
        all_alphas = [] if capture is not None else None
        for li, heads in enumerate(self.layers):
            layer_residual = self.residual and li < n_layers - 1
            if use_fused:
                outs = self._fused_layer(heads, h, adj, training=training,
                                         generator=generator,
                                         residual=layer_residual,
                                         capture_alpha=all_alphas)
            else:
                layer_alphas = [] if capture is not None else None
                outs = [self._attn_head(p, h, adj, training=training,
                                        generator=generator,
                                        capture_alpha=layer_alphas,
                                        residual=layer_residual)
                        for p in heads]
                if capture is not None:
                    all_alphas.append(torch.stack(layer_alphas))
            if li < n_layers - 1:
                # residual already applied per head, pre-activation
                h = torch.cat([torch.nn.functional.elu(o) for o in outs],
                              dim=1)
            else:
                h = sum(outs) / len(outs)  # output heads averaged, no act
            if capture is not None:
                capture[f"activations/{li}-gat"] = h
        if capture is not None:
            self.last_attn_coefs = all_alphas
        return h

    def get_embeddings(self, adj, x, adjhops=()):
        """The input of the output layer: every hidden layer's heads,
        ELU'd and concatenated, in eval mode. Computed on the segment path
        whatever the payload, as the JAX package does."""
        h = x
        for heads in self.layers[:-1]:
            h = torch.cat([torch.nn.functional.elu(
                self._attn_head(p, h, adj, training=False, generator=None))
                for p in heads], dim=1)
        return h

    # ---------------------------------------------------------------- loss
    def l2_loss(self) -> torch.Tensor:
        # l2_coef · Σ ½‖θ‖² over every trainable tensor (tf.nn.l2_loss
        # halves; the reference's name-based bias exclusion matches nothing
        # in practice — quirk preserved, base_gattn.py:14-18)
        total = sum(torch.sum(torch.square(p)) for p in self.parameters())
        return self.l2_coef * 0.5 * total

    def loss(self, logits, labels, mask) -> torch.Tensor:
        return masked_softmax_cross_entropy(logits, labels, mask) + self.l2_loss()


class GATPatienceController:
    """Reference GAT early stopping: stop after ``patience`` epochs with
    neither a new best val_acc nor a new best val_loss
    (execute_cora_sparse.py:200-230). Consumes the epoch stats dict."""

    def __init__(self, patience):
        self.patience = patience
        self.vacc_mx = -np.inf
        self.vlss_mn = np.inf
        self.curr_step = 0

    def __call__(self, epoch_stats) -> bool:
        vacc = tracing.readback(epoch_stats["val_acc"])
        vlss = tracing.readback(epoch_stats["val_loss"])
        if vacc >= self.vacc_mx or vlss <= self.vlss_mn:
            self.vacc_mx = max(vacc, self.vacc_mx)
            self.vlss_mn = min(vlss, self.vlss_mn)
            self.curr_step = 0
            return False
        self.curr_step += 1
        return self.patience > 0 and self.curr_step >= self.patience


class _StatsPatience:
    """Adapter: the runtime calls controller(val_loss); GAT's controller
    needs the full stats dict, which it reads from args.objects each
    epoch."""

    def __init__(self, args, inner):
        self.args = args
        self.inner = inner

    def __call__(self, _val_loss):
        return self.inner(self.args.objects["epoch_stats"])


def add_subparser_args(parser):
    group = parser.add_argument_group("GAT Model Arguments (GAT.py)")
    group.add_argument("--lr", default=0.005, type=float)
    group.add_argument("--l2_coef", default=0.0005, type=float)
    group.add_argument("--hid_units", default=[8], nargs="*", type=int)
    group.add_argument("--n_heads", default=[8, 1], nargs="*", type=int)
    group.add_argument("--in_drop", default=0.6, type=float)
    group.add_argument("--attn_drop", default=0.6, type=float)
    group.add_argument("--residual", default=False, action="store_true")
    group.add_argument("--nhood", default=1, type=float,
                       help="Attention neighborhood radius: k-hop "
                            "reachability mask (1 = standard GAT; inf = "
                            "attention over all node pairs). Reference "
                            "dense-GAT adj_to_bias semantics "
                            "(utils/process.py:15-32, execute_cora.py)")
    group.add_argument("--patience", default=100, type=int)
    group.add_argument("--fused_attention", action="store_true",
                       help="Use the fused attention payloads: the BSR mask "
                            "(edge lists built once from it, walked by "
                            "csrc/gat_attention_{coo,col}.cu) within the BSR "
                            "budget, past it the gather payload "
                            "(csrc/gscatter_weighted.cu) or the COO-chunk "
                            "kernels (csrc/gat_attention_coo.cu); with the "
                            "BSR and COO-chunk payloads the segment path "
                            "runs instead when attention dropout is active "
                            "or coefficients are captured")
    group.add_argument("--fused_precision", default="highest",
                       choices=["highest", "default"],
                       help="Head-contraction precision of the gather and "
                            "COO-chunk payloads: highest = f32, default = "
                            "bf16 operands with f32 sums (the BSR kernels "
                            "run in f32 either way)")
    group.add_argument("--attn_impl", default="auto",
                       choices=["auto", "coo", "gather"],
                       help="Fused-attention payload past the BSR budget "
                            "(an explicit choice also overrides the "
                            "budget): gather = edge-major softmax terms and "
                            "weighted gather-scatter combines (also "
                            "expresses --attn_drop), coo = flash-style "
                            "COO-chunk kernels (no edge-sized buffers); "
                            "auto takes gather unless its edge streams pass "
                            "the stream budget, then coo")
    group.add_argument("--optimizer", type=str, default="adam")
    group.add_argument("--no_feature_normalize", action="store_true")
    group.add_argument("--best_val_criteria", choices=["val_acc", "val_loss"],
                       default="val_acc")
    group.add_argument("--save_activations", action="store_true")
    group.add_argument("--save_predictions", nargs="+", type=bool, default=True)
    parser.function_hooks["argparse"].append(argparse_callback)


def build_attention_support(dataset, nhood):
    """k-hop self-looped reachability support (reference utils/process.py:
    15-32 adj_to_bias / :122-131 preprocess_adj_bias)."""
    import scipy.sparse as sp

    if np.isinf(nhood):
        n = dataset.num_samples
        if n * n > 250_000_000:
            # all-ones attention support is an n^2 materialization (reference
            # adj_to_bias semantics) — refuse past ~1GB instead of silently
            # exhausting host memory on a large graph
            raise ValueError(
                f"--nhood inf builds a dense {n}x{n} all-pairs support "
                f"({n * n:,} entries) — use a finite --nhood at this scale")
        return sp.csr_matrix(np.ones((n, n), np.float32))
    if nhood == 1:
        return transforms.add_eye(dataset.sparse_adj)
    hops = transforms.nhood_split(dataset.sparse_adj, int(nhood))
    return transforms.add_eye(sum(hops[1:]))


# The dense-block BSR payload budget: past it the fused attention moves to
# the O(nnz) gather or COO-chunk payloads. 256 MB is the JAX package's
# value, chosen on a TPU; the port keeps it until the H100 crossover of the
# three payloads (PERF.md) sets its own (ROADMAP A6).
_BSR_PAYLOAD_BUDGET_BYTES = 256 * 1024 * 1024

# The gather payload's budget for its tables and edge-sized streams: a
# quarter of the H100's 80 GB, leaving the rest to the features, the model,
# its activations and the allocator's slack. Past it `auto` takes the
# COO-chunk payload, which holds no edge-sized buffer.
_GATHER_STREAM_BUDGET_BYTES = 20 * 1024 ** 3


def _gather_stream_bytes(n: int, nnz: int, heads: int = 8) -> int:
    """Estimate of the device bytes the gather payload holds at its peak,
    counting the port's own buffers (:mod:`..sparse.attention_gather`):

    * the gscatter tables in both orientations: rows, cols and vals (12 B
      a slot) and the slot -> edge map (4 B), each twice; slots estimated
      at 115% of nnz plus 8 chunks of 128 a stripe of ``GATHER_TILE``
      rows;
    * the edge list (two int64 columns, 16 B an edge) and the slot maps of
      each edge (16 B);
    * the [E, H] f32 edge streams live at once in the backward (s, p,
      live, q, q * m, p * m, the dropout mask and an index temporary):
      ~8 of them.

    The combines gather inside the kernel, so no [slots, F] buffer exists.
    """
    slots = int(nnz * 1.15) + (-(-n // GATHER_TILE)) * 8 * 128
    per_slot = 2 * (12 + 4)
    per_edge = heads * 4 * 8 + 16 + 16
    return slots * per_slot + nnz * per_edge


def build_gat_adjacency(support, fused_attention: bool,
                        block_size: int = 256, attn_impl: str = "auto",
                        device="cpu") -> SparseMatrix:
    """Fused-path payload selection at construction time.

    Without ``fused_attention`` the support is a segment matrix. With it, a
    graph whose 256-block BSR payload fits the budget gets the f32 mask
    blocks the BSR kernels read; a larger graph (or any explicit
    ``attn_impl``) gets O(nnz) tables: the gather payload, unless its edge
    streams would pass the stream budget, and then the COO-chunk payload
    (``attn_impl="coo"`` forces it). All keep the COO arrays, so the
    segment path runs off the same matrix."""
    import scipy.sparse as sp

    if not fused_attention:
        return SparseMatrix.from_scipy(support, backend="segment",
                                       block_size=128, device=device)
    coo = sp.coo_matrix(support)
    ncb = -(-support.shape[1] // block_size)
    pair_keys = ((coo.row // block_size).astype(np.int64) * ncb
                 + coo.col // block_size)
    nb = np.unique(pair_keys).size
    payload = nb * block_size * block_size * 4
    # an explicit payload overrides the BSR budget
    if attn_impl != "auto" or payload > _BSR_PAYLOAD_BUDGET_BYTES:
        if attn_impl == "auto":
            attn_impl = ("coo" if _gather_stream_bytes(support.shape[0],
                                                       coo.nnz)
                         > _GATHER_STREAM_BUDGET_BYTES else "gather")
        return SparseMatrix.from_scipy(support, backend="attn",
                                       attn_tile=block_size,
                                       attn_impl=attn_impl, device=device)
    return SparseMatrix.from_scipy(support, backend="bsr",
                                   block_size=block_size, device=device)


def argparse_callback(args):
    dataset = args.objects["dataset"]
    device = torch.device(args._device)
    if not args.no_feature_normalize:
        dataset.row_normalize_features()
    tensors = dataset.get_tensors(backend="segment", device=device)
    tensors.adj_hops = []
    # the attention support replaces the raw adjacency in the tensors
    with tracing.phase("setup.payload"):
        support = build_attention_support(dataset, args.nhood)
        tensors.adj = build_gat_adjacency(support, args.fused_attention,
                                          attn_impl=args.attn_impl,
                                          device=device)
    args.objects["tensors"] = vars(tensors)

    model = GATNetwork(
        dataset.num_labels,
        hid_units=args.hid_units, n_heads=args.n_heads,
        in_drop=args.in_drop, attn_drop=args.attn_drop,
        residual=args.residual, l2_coef=args.l2_coef,
        fused_attention=args.fused_attention,
        fused_precision=args.fused_precision,
    )
    controller = _StatsPatience(args, GATPatienceController(args.patience))
    _runtime.initialize_model(
        args, model, args.optimizer, args.lr, controller,
        seed=getattr(args, "random_seed", None),
    )

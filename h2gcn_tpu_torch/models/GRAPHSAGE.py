"""GraphSAGE baseline (Hamilton et al. 2017), supervised, mean aggregator.

The port of ``h2gcn_tpu.models.GRAPHSAGE``. Reference semantics
(baselines/graphsage-simple/graphsage/):

* mean aggregator: a uniform draw of ``num_sample`` neighbors without
  replacement (all of them when the degree is below k), mean of their
  embeddings;
* encoder ``ReLU(concat(self, neigh) · W)``, two stacked, hidden 128;
* a linear scorer, CE loss over a 256-node train batch an epoch, SGD lr 0.7;
* the Concat(+JK) variant classifies ``concat(enc1, enc2)``.

Neighbor lists live in a padded ELL table ``[N, Dmax]``; the draw is the
top-k of uniform random scores over each row's valid slots. Full-neighbor
fan-outs (0) aggregate through the SpMM ladder as ``D⁻¹A·x``
(:func:`build_mean_adjacencies`), which needs no ``[N·Dmax, F]`` gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..nn.metrics import masked_softmax_cross_entropy
from ..sparse import SparseMatrix, spmm
from . import _runtime


@dataclasses.dataclass
class ELLGraph:
    """Padded ELL neighbor table, carried in the ``adj`` tensor slot.

    ``mean_adj`` / ``mean_adj_gcn`` are the optional row-normalized
    matrices ``D⁻¹A`` / ``D'⁻¹(A+I)`` that carry the full-neighbor mean
    through the SpMM ladder."""

    table: torch.Tensor  # [N, Dmax] int64 neighbor ids
    valid: torch.Tensor  # [N, Dmax] bool
    nnz: int
    mean_adj: object = None        # SparseMatrix D⁻¹A or None
    mean_adj_gcn: object = None    # SparseMatrix D'⁻¹(A+I) or None

    @property
    def shape(self):
        n = self.table.shape[0]
        return (n, n)

    def to_scipy(self):
        t = self.table.cpu().numpy()
        v = self.valid.cpu().numpy()
        rows = np.repeat(np.arange(t.shape[0]), t.shape[1])[v.ravel()]
        cols = t.ravel()[v.ravel()]
        return sp.csr_matrix(
            (np.ones(rows.size, np.float32), (rows, cols)), shape=self.shape
        )


def build_neighbor_table(adj_csr, device="cpu"):
    """Padded ELL neighbor table [N, Dmax] and its validity mask, on
    ``device`` (the native host builder, :func:`~h2gcn_tpu_torch.native.
    build_ell`)."""
    from ..native import build_ell

    table, valid = build_ell(adj_csr)
    return (torch.from_numpy(table.astype(np.int64)).to(device),
            torch.from_numpy(valid).to(device))


def _glorot(shape, generator):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return nn.Parameter((torch.rand(*shape, generator=generator) * 2 - 1)
                        * limit)


class GraphSAGENetwork(nn.Module):
    """Two-layer supervised GraphSAGE with the runtime's model interface:
    ``W1``, ``W2`` (the encoders, ``[in, out]``) and ``Wout`` (the
    scorer). The neighbor table arrives per call as ``adj``
    (:class:`ELLGraph`)."""

    def __init__(self, num_classes, *, hid_units=128,
                 num_samples=(5, 5), concat_jk=False, gcn_aggregator=False,
                 gcn_encoder=False):
        super().__init__()
        self.num_classes = num_classes
        self.hid_units = hid_units
        self.num_samples = list(num_samples)
        self.concat_jk = concat_jk
        self.gcn_aggregator = gcn_aggregator
        self.gcn_encoder = gcn_encoder

    def init(self, input_dim: int, num_hops: int, generator: torch.Generator,
             device="cpu") -> "GraphSAGENetwork":
        mult = 1 if self.gcn_encoder else 2
        out_in = self.hid_units * (2 if self.concat_jk else 1)
        self.W1 = _glorot((mult * input_dim, self.hid_units), generator)
        self.W2 = _glorot((mult * self.hid_units, self.hid_units), generator)
        self.Wout = _glorot((out_in, self.num_classes), generator)
        return self.to(device)

    def _sampled_mean(self, ell, feats, generator, num_sample):
        """Mean of at most ``num_sample`` neighbors per node drawn uniformly
        without replacement; nodes with fewer neighbors use all of them.
        The full-neighbor mean (``num_sample`` <= 0 or >= dmax) takes the
        SpMM ladder when the row-normalized matrix is attached: the same
        mean (``D⁻¹A·x``, zero-degree rows 0 both ways)."""
        eff_dmax = ell.table.shape[1] + (1 if self.gcn_aggregator else 0)
        full = num_sample is None or num_sample <= 0 \
            or num_sample >= eff_dmax
        madj = ell.mean_adj_gcn if self.gcn_aggregator else ell.mean_adj
        if full and madj is not None:
            return spmm(madj, feats)
        table, valid = ell.table, ell.valid
        if self.gcn_aggregator:
            n = table.shape[0]
            self_col = torch.arange(n, dtype=table.dtype,
                                    device=table.device)[:, None]
            table = torch.cat([table, self_col], dim=1)
            valid = torch.cat([valid, torch.ones(n, 1, dtype=torch.bool,
                                                 device=valid.device)], dim=1)
        dmax = table.shape[1]
        if num_sample is None or num_sample <= 0 or num_sample >= dmax:
            sel, sel_valid = table, valid  # the full-neighbor mean
        else:
            scores = torch.rand(table.shape, generator=generator,
                                device=table.device)
            scores = torch.where(valid, scores,
                                 torch.full((), -torch.inf,
                                            device=scores.device))
            top_scores, top_idx = torch.topk(scores, num_sample, dim=1)
            sel = torch.gather(table, 1, top_idx)
            sel_valid = torch.isfinite(top_scores)
        # the valid (node, slot) pairs summed by node: O(pairs · F) memory
        # where the padded [N, Dmax, F] gather of a hub-heavy table is not
        rows, slots = torch.nonzero(sel_valid, as_tuple=True)
        total = torch.zeros(feats.shape, dtype=feats.dtype,
                            device=feats.device).index_add_(
            0, rows, feats[sel[rows, slots]])
        count = torch.clamp(sel_valid.sum(dim=1, keepdim=True), min=1)
        return total / count.to(feats.dtype)

    def _encode(self, ell, w, feats, generator, num_sample):
        neigh = self._sampled_mean(ell, feats, generator, num_sample)
        combined = neigh if self.gcn_encoder else torch.cat([feats, neigh],
                                                            dim=1)
        return torch.relu(torch.matmul(combined, w))

    def forward(self, adj, x, adjhops=(), *, training=False, generator=None,
                capture=None):
        # the reference samples in training and in evaluation; evaluation
        # here draws from a fixed seed, so model selection is deterministic
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        h1 = self._encode(adj, self.W1, x, generator, self.num_samples[0])
        h2 = self._encode(adj, self.W2, h1, generator, self.num_samples[1])
        if capture is not None:
            capture["activations/0-enc1"] = h1
            capture["activations/1-enc2"] = h2
        embeds = torch.cat([h1, h2], dim=1) if self.concat_jk else h2
        return torch.matmul(embeds, self.Wout)

    def get_embeddings(self, adj, x, adjhops=()):
        """The first encoder's output, its neighbors drawn as in
        evaluation (a generator seeded with 0)."""
        generator = torch.Generator(device=x.device).manual_seed(0)
        return self._encode(adj, self.W1, x, generator, self.num_samples[0])

    def l2_loss(self) -> torch.Tensor:
        return torch.zeros((), device=self.Wout.device)  # no weight decay

    def loss(self, logits, labels, mask) -> torch.Tensor:
        return masked_softmax_cross_entropy(logits, labels, mask)


def load_jax_graphsage_params(model: GraphSAGENetwork,
                              params) -> GraphSAGENetwork:
    """Load the JAX ``GraphSAGENetwork``'s ``{"W1", "W2", "Wout"}`` (numpy
    arrays) into an initialized port model."""
    if set(params) != {"W1", "W2", "Wout"}:
        raise KeyError(f"GraphSAGE parameters {sorted(params)} != "
                       "['W1', 'W2', 'Wout']")
    with torch.no_grad():
        for key, value in params.items():
            src = torch.from_numpy(np.array(value, dtype=np.float32))
            dst = getattr(model, key)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    return model


def add_subparser_args(parser):
    group = parser.add_argument_group("GraphSAGE Model Arguments (GRAPHSAGE.py)")
    group.add_argument("--batch_size", default=256, type=int)
    group.add_argument("--lr", "--learning_rate", default=0.7, type=float)
    group.add_argument("--hid_units", default=128, type=int)
    group.add_argument("--num_samples", nargs="+", default=[5, 5], type=int,
                       help="Neighbor sample fan-out per layer; 0 or "
                            "negative = all neighbors (full-neighbor mode)")
    group.add_argument("--gcn_encoder", action="store_true")
    group.add_argument("--gcn_aggregator", action="store_true")
    group.add_argument("--model_class", choices=[
        "SupervisedGraphSage", "SupervisedGraphSageConcat"],
        default="SupervisedGraphSage")
    group.add_argument("--optimizer", type=str, default="sgd")
    group.add_argument("--early_stopping", type=int, default=0)
    group.add_argument("--best_val_criteria", choices=["val_acc", "val_loss"],
                       default="val_acc")
    group.add_argument("--save_activations", action="store_true")
    group.add_argument("--save_predictions", nargs="+", type=bool, default=True)
    parser.function_hooks["argparse"].append(argparse_callback)


def build_mean_adjacencies(adj_csr, *, gcn: bool, backend: str = "auto",
                           device="cpu") -> SparseMatrix:
    """The row-normalized full-neighbor mean operator of :class:`ELLGraph`
    (``D⁻¹A``, or ``D'⁻¹(A+I)`` for the GCN aggregator) on the SpMM
    ladder. Zero-degree rows stay zero (the mean of nothing, as the ELL
    path's max(count, 1) guard gives)."""
    a = sp.csr_matrix(adj_csr).astype(np.float32)
    if gcn:
        a = a + sp.eye(a.shape[0], format="csr", dtype=np.float32)
    deg = np.asarray(a.sum(axis=1)).ravel()
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    return SparseMatrix.from_scipy(sp.diags(inv) @ a, backend=backend,
                                   device=device)


def argparse_callback(args):
    dataset = args.objects["dataset"]
    device = torch.device(args._device)
    tensors = dataset.get_tensors(backend="segment", device=device)
    tensors.adj_hops = []
    # the ELL neighbor table rides the adj tensor slot
    table, valid = build_neighbor_table(dataset.sparse_adj.tocsr(), device)
    # full-neighbor fan-outs (0) aggregate through the SpMM ladder
    mean_adj = mean_adj_gcn = None
    if any(s <= 0 for s in args.num_samples):
        mean_adj = build_mean_adjacencies(dataset.sparse_adj, gcn=False,
                                          device=device)
        if args.gcn_aggregator:
            mean_adj_gcn = build_mean_adjacencies(dataset.sparse_adj,
                                                  gcn=True, device=device)
    tensors.adj = ELLGraph(table=table, valid=valid,
                           mean_adj=mean_adj, mean_adj_gcn=mean_adj_gcn,
                           nnz=int(dataset.sparse_adj.nnz))
    args.objects["tensors"] = vars(tensors)

    model = GraphSAGENetwork(
        dataset.num_labels,
        hid_units=args.hid_units,
        num_samples=args.num_samples,
        concat_jk=(args.model_class == "SupervisedGraphSageConcat"),
        gcn_aggregator=args.gcn_aggregator,
        gcn_encoder=args.gcn_encoder,
    )
    _runtime.initialize_model(
        args, model, args.optimizer, args.lr, args.early_stopping,
        seed=getattr(args, "random_seed", None),
    )

    # minibatches: each epoch trains on a random subset of batch_size train
    # nodes, by re-masking before every epoch; the draws are the JAX
    # package's (one np.random.RandomState)
    full_train_mask = tensors.train_mask.cpu().numpy().astype(bool)
    train_idx = np.where(full_train_mask)[0]
    if args.batch_size and args.batch_size < len(train_idx):
        batch_rng = np.random.RandomState(
            getattr(args, "random_seed", 123) or 123)
        y_all = tensors.y_all.cpu().numpy()

        def subsample_batch(epoch, args):
            pick = batch_rng.choice(train_idx, args.batch_size, replace=False)
            mask = np.zeros_like(full_train_mask)
            mask[pick] = True
            t = args.objects["tensors"]
            t["train_mask"] = torch.from_numpy(
                mask.astype(np.float32)).to(device)
            y = np.zeros_like(y_all)
            y[mask] = y_all[mask]
            t["y_train"] = torch.from_numpy(y).to(device)

        args.objects["pre_epoch_callbacks"].append(subsample_batch)

"""GCN baseline family: GCN / GCN-Cheby / GCN+JK (Concat2) / MLP / BP.

The port of ``h2gcn_tpu.models.GCN``: Kipf & Welling GCN semantics on the
port's SpMM core and layer program.

* ``gcn``      dropout -> XW -> ÂZ -> ReLU, twice (Â = sym_norm(A+I));
  weight decay ``5e-4 · ½‖W₁‖²`` on the first layer only.
* ``cheby``    per-support weights ``Σₖ Tₖ(L̃) Z Wₖ`` through the [stack
  hops -> flatten -> one wide dense] identity (exact: SpMM is linear);
  ``--cheby_eigenvalue 2`` is the fixed-eigenvalue option.
* ``concat2``  GCN+JK: Dense -> GC -> GC, concat of the last three
  activations, dense classifier; ``cheby_concat2`` the same over the
  Chebyshev supports.
* ``mlp``      two dense layers, no aggregation.
* ``bp``       linearized belief propagation over the RW-normalized
  adjacency, with no trainable parameter.

Defaults: hidden1 16, dropout 0.5, lr 0.01, weight decay 5e-4, 10-epoch
mean-window early stopping.
"""

import numpy as np
import torch
from torch import nn

from .. import nn as tnn
from ..nn.dsl import Layer
from ..nn.metrics import masked_softmax_cross_entropy
from ..sparse import spmm, transforms
from ..sparse.transforms import NType
from . import _runtime


class BeliefPropagationNetwork(nn.Module):
    """Linearized belief propagation over the graph.

    ``beliefs = softmax(Σ_i S_i · log(X·H + ε) + log(X + ε))`` with a fixed
    class-compatibility matrix H. Use with ``--feature_configs labels``
    one-hot label priors. It has no trainable parameter: ``dummy`` (one
    zero, no gradient) stands in for the JAX package's dummy leaf, so the
    optimizer has a parameter list and the checkpoint an entry.
    """

    def __init__(self, num_classes, h_matrix=None, homophily=None):
        super().__init__()
        import scipy.linalg

        self.num_classes = num_classes
        if h_matrix is None:
            if homophily is not None:
                off = (1 - homophily) / max(num_classes - 1, 1)
                h_matrix = (homophily * np.eye(num_classes)
                            + off * (np.ones((num_classes, num_classes))
                                     - np.eye(num_classes)))
            elif num_classes == 5:  # the reference's default circulant
                h_matrix = scipy.linalg.circulant(
                    [0, 2 / 6, 1 / 6, 1 / 6, 2 / 6])
            else:
                h_matrix = (np.ones((num_classes, num_classes))
                            - np.eye(num_classes)) / max(num_classes - 1, 1)
        self.register_buffer("h_matrix", torch.from_numpy(
            np.asarray(h_matrix, np.float32)))

    def init(self, input_dim: int, num_hops: int, generator: torch.Generator,
             device="cpu") -> "BeliefPropagationNetwork":
        assert input_dim == self.num_classes, (
            "BP expects one-hot label priors (--feature_configs labels)")
        self.dummy = nn.Parameter(torch.zeros(1), requires_grad=False)
        return self.to(device)

    def forward(self, adj, x, adjhops, *, training=False, generator=None,
                capture=None):
        eps = 1e-7
        message = torch.log(torch.matmul(x, self.h_matrix) + eps)
        total = 0.0
        for support in adjhops:
            total = total + spmm(support, message)
        out = torch.softmax(total + torch.log(x + eps), dim=-1)
        if capture is not None:
            capture["activations/0-belief_propagation"] = out
        return out

    def get_embeddings(self, adj, x, adjhops):
        raise NotImplementedError  # as in the JAX package: BP has none

    def l2_loss(self) -> torch.Tensor:
        return torch.zeros((), device=self.h_matrix.device)

    def loss(self, logits, labels, mask) -> torch.Tensor:
        return masked_softmax_cross_entropy(logits, labels, mask)


def add_subparser_args(parser):
    group = parser.add_argument_group("GCN Model Arguments (GCN.py)")
    group.add_argument("--variant",
                       choices=["gcn", "cheby", "concat2", "cheby_concat2",
                                "mlp", "bp"],
                       default="gcn")
    group.add_argument("--hidden1", type=int, default=16)
    group.add_argument("--dropout", type=float, default=0.5)
    group.add_argument("--lr", "--learning_rate", type=float, default=0.01,
                       dest="lr")
    group.add_argument("--weight_decay", type=float, default=5e-4)
    group.add_argument("--early_stopping", type=int, default=10)
    group.add_argument("--max_degree", type=int, default=3,
                       help="Chebyshev polynomial order (cheby variant)")
    group.add_argument("--cheby_eigenvalue", type=float, default=2,
                       help="Fixed largest Laplacian eigenvalue. 2 is the "
                            "reference's effective default. Pass a negative "
                            "value to compute it with ARPACK instead.")
    group.add_argument("--bp_homophily", type=float, default=None,
                       help="Class-compatibility homophily for the bp "
                            "variant (None: the reference circulant/uniform)")
    group.add_argument("--optimizer", type=str, default="adam")
    group.add_argument("--best_val_criteria", choices=["val_acc", "val_loss"],
                       default="val_acc")
    group.add_argument("--save_activations", action="store_true")
    group.add_argument("--save_predictions", nargs="+", type=bool, default=True)
    group.add_argument("--sparse_backend",
                       choices=["auto", "dense", "bsr", "cootile", "gscatter",
                                "segment"],
                       default="auto")
    group.add_argument("--reorder", choices=["none", "rcm", "cluster"],
                       default="none",
                       help="Tile-clustering node permutation (see H2GCN "
                            "--reorder); layout-only, outputs restored to "
                            "original node order on save")
    parser.function_hooks["argparse"].append(argparse_callback)


def build_layer_setups(variant, hidden, dropout, num_labels):
    """Layer program per variant. ``l2_scale=0.5`` on the first parametric
    layer is the reference's halved first-layer-only weight decay."""
    D, M, G, V, R, C = (Layer.DROPOUT, Layer.DENSE, Layer.GCN,
                        Layer.VECTORIZE, Layer.RELU, Layer.CONCAT)

    def dense(units, out=False, l2=0.0, tag=None):
        conf = dict(units=units, use_bias=False, l2_scale=l2)
        if out:
            conf["beginOutput"] = True
        if tag:
            conf["tag"] = tag
        return (M, conf)

    drop = (D, dict(dropout_rate=dropout))
    if variant == "gcn":
        return [
            drop, dense(hidden, l2=0.5), (G, dict(hops=None)), (V, {}), (R, {}),
            drop, dense(num_labels, out=True), (G, dict(hops=None)), (V, {}),
        ]
    if variant == "cheby":
        # spmm first; the wide dense realizes the per-support weights
        return [
            drop, (G, dict(hops=None)), (V, {}), dense(hidden, l2=0.5), (R, {}),
            drop, (G, dict(hops=None)), (V, {}), dense(num_labels, out=True),
        ]
    if variant == "concat2":
        return [
            drop, dense(hidden, l2=0.5), (R, dict(tag="1")),
            drop, dense(hidden), (G, dict(hops=None)), (V, {}),
            (R, dict(tag="2")),
            drop, dense(hidden), (G, dict(hops=None)), (V, {}),
            (R, dict(tag="3")),
            (C, dict(tags=["1", "2", "3"], addInputs=False)),
            drop, dense(num_labels, out=True),
        ]
    if variant == "cheby_concat2":
        # GCN+JK over the Chebyshev supports, spmm first as in cheby
        return [
            drop, dense(hidden, l2=0.5), (R, dict(tag="1")),
            drop, (G, dict(hops=None)), (V, {}), dense(hidden),
            (R, dict(tag="2")),
            drop, (G, dict(hops=None)), (V, {}), dense(hidden),
            (R, dict(tag="3")),
            (C, dict(tags=["1", "2", "3"], addInputs=False)),
            drop, dense(num_labels, out=True),
        ]
    if variant == "mlp":
        return [
            drop, dense(hidden, l2=0.5), (R, {}),
            drop, dense(num_labels, out=True),
        ]
    raise ValueError(f"unknown GCN variant {variant}")


def _reorder(args):
    r = getattr(args, "reorder", "none")
    return None if r in (None, "none") else r


def argparse_callback(args):
    dataset = args.objects["dataset"]
    device = torch.device(args._device)
    if args.variant == "bp":
        # label priors propagate over the RW-normalized adjacency
        supports = [
            transforms.normalize(dataset.sparse_adj, NType.RW_NORMALIZED)
        ]
        tensors = dataset.get_tensors(supports=supports,
                                      backend=args.sparse_backend,
                                      reorder=_reorder(args), device=device)
        args.objects["tensors"] = vars(tensors)
        model = BeliefPropagationNetwork(dataset.num_labels,
                                         homophily=args.bp_homophily)
        _runtime.initialize_model(
            args, model, args.optimizer, args.lr, args.early_stopping,
            seed=getattr(args, "random_seed", None),
        )
        return
    dataset.row_normalize_features()
    if args.variant in ("cheby", "cheby_concat2"):
        eig = args.cheby_eigenvalue
        supports = transforms.chebyshev_polynomials(
            dataset.sparse_adj, args.max_degree,
            eigenvalue=(None if eig is not None and eig < 0 else eig),
        )
    elif args.variant == "mlp":
        supports = []
    else:
        supports = [
            transforms.normalize(
                transforms.add_eye(dataset.sparse_adj), NType.SYM_NORMALIZED
            )
        ]
    tensors = dataset.get_tensors(
        supports=supports, backend=args.sparse_backend,
        reorder=_reorder(args), device=device,
    )
    args.objects["tensors"] = vars(tensors)

    layer_setups = build_layer_setups(
        args.variant, args.hidden1, args.dropout, dataset.num_labels
    )
    model = tnn.NetworkModel(layer_setups,
                             l2_regularize_weight=args.weight_decay)
    _runtime.initialize_model(
        args, model, args.optimizer, args.lr, args.early_stopping,
        seed=getattr(args, "random_seed", None),
    )

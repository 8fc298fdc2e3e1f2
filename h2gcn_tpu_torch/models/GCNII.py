"""GCNII (Chen, Wei, Huang, Ding and Li, ICML 2020, "Simple and Deep Graph
Convolutional Networks", arXiv 2007.02133; official code
github.com/chennnM/GCNII), the non-variant model without the extra
residual. The JAX package has no GCNII; this plugin follows the official
code::

    Ã   = D̃^-1/2 (A + I) D̃^-1/2            (the GCN family's support)
    h0  = relu(dropout(X) W_in + b_in)       (X row-normalized)
    for l = 1 .. L:
        s = (1 - α) Ã dropout(h) + α h0      (h = h0 at l = 1)
        β = ln(λ / l + 1)
        h = relu(β s W_l + (1 - β) s)        (W_l [hidden, hidden], no bias)
    logits = dropout(h) W_out + b_out

The loss is the masked cross-entropy plus ``(wd1 / 2) Σ_l |W_l|²`` and
``(wd2 / 2) (|W_in|² + |b_in|² + |W_out|² + |b_out|²)``: torch's coupled
``weight_decay=wd`` adds ``wd · w`` to a gradient, the gradient of
``(wd / 2) |w|²``. The defaults are the paper's deep Cora row: 64 layers,
hidden 64, α 0.1, λ 0.5, dropout 0.6, lr 0.01, wd1 0.01 on the
convolutions, wd2 5e-4 on the dense layers, patience 100.

Departures from the official code: the runtime's keras-rule Adam (eps
1e-7) in place of ``torch.optim.Adam`` (eps 1e-8); the weights drawn from
the run's seeded CPU generator in layer order (``W_in``, ``b_in``, ``W_1``
.. ``W_L``, ``W_out``, ``b_out``), by the published rules (a convolution
uniform in ±1/√hidden, a dense layer's weight and bias in ±1/√fan_in);
early stopping by :class:`~h2gcn_tpu_torch.modules.controller.
PatienceEarlyStopping` on the validation loss, which stops one epoch later
than the official counter.

Each layer's forward is a ``gcnii.layer`` span (attribute ``l``) around
its ``spmm`` span, and counts ``gcnii.layers``.
"""

import math

import torch
from torch import nn

from .. import tracing
from ..modules.controller import PatienceEarlyStopping
from ..nn.metrics import masked_softmax_cross_entropy
from ..nn.ops import dropout
from ..sparse import spmm, transforms
from ..sparse.transforms import NType
from . import _runtime


def betas(layers: int, lamda: float) -> list:
    """The identity mapping's weight of each layer, ``ln(λ / l + 1)`` for
    l = 1 .. ``layers``."""
    return [math.log(lamda / l + 1.0) for l in range(1, layers + 1)]


def _uniform(shape, bound, generator):
    return (torch.rand(*shape, generator=generator) * 2 - 1) * bound


class GCNIINetwork(nn.Module):
    """GCNII with the runtime's model interface. Parameters: ``w_in``
    [in, hidden], ``b_in``, ``convs.<l - 1>`` [hidden, hidden], ``w_out``
    [hidden, classes], ``b_out``. Call :meth:`init` once before the first
    forward."""

    def __init__(self, num_classes, *, layers=64, hidden=64, alpha=0.1,
                 lamda=0.5, dropout=0.6, wd1=0.01, wd2=5e-4):
        super().__init__()
        self.num_classes = num_classes
        self.layers = layers
        self.hidden = hidden
        self.alpha = alpha
        self.betas = betas(layers, lamda)
        self.dropout = dropout
        self.wd1 = wd1
        self.wd2 = wd2

    def init(self, input_dim: int, num_hops: int, generator: torch.Generator,
             device="cpu") -> "GCNIINetwork":
        hid, c = self.hidden, self.num_classes
        b_in, b_hid = 1.0 / math.sqrt(input_dim), 1.0 / math.sqrt(hid)
        self.w_in = nn.Parameter(_uniform((input_dim, hid), b_in, generator))
        self.b_in = nn.Parameter(_uniform((hid,), b_in, generator))
        self.convs = nn.ParameterList(
            [_uniform((hid, hid), b_hid, generator)
             for _ in range(self.layers)])
        self.w_out = nn.Parameter(_uniform((hid, c), b_hid, generator))
        self.b_out = nn.Parameter(_uniform((c,), b_hid, generator))
        return self.to(device)

    def _hidden(self, support, x, training, generator, capture):
        x = dropout(x, self.dropout, generator, training)
        h0 = torch.relu(torch.matmul(x, self.w_in) + self.b_in)
        mixed_h0 = self.alpha * h0
        h = h0
        for l, (w, beta) in enumerate(zip(self.convs, self.betas), 1):
            with tracing.span("gcnii.layer", l=l):
                tracing.count("gcnii.layers")
                z = dropout(h, self.dropout, generator, training)
                s = torch.add(mixed_h0, spmm(support, z),
                              alpha=1.0 - self.alpha)
                # β s W_l + (1 - β) s in one product
                h = torch.relu(torch.addmm(s, s, w, beta=1.0 - beta,
                                           alpha=beta))
            if capture is not None:
                capture[f"activations/{l}-gcnii"] = h
        return h

    def forward(self, adj, x, adjhops, *, training=False, generator=None,
                capture=None):
        h = self._hidden(adjhops[0], x, training, generator, capture)
        h = dropout(h, self.dropout, generator, training)
        return torch.matmul(h, self.w_out) + self.b_out

    def get_embeddings(self, adj, x, adjhops):
        """The input of the output layer, in eval mode."""
        return self._hidden(adjhops[0], x, False, None, None)

    def l2_loss(self) -> torch.Tensor:
        convs = sum(torch.sum(torch.square(w)) for w in self.convs)
        dense = sum(torch.sum(torch.square(p)) for p in
                    (self.w_in, self.b_in, self.w_out, self.b_out))
        return 0.5 * self.wd1 * convs + 0.5 * self.wd2 * dense

    def loss(self, logits, labels, mask) -> torch.Tensor:
        return masked_softmax_cross_entropy(logits, labels, mask) + self.l2_loss()


def add_subparser_args(parser):
    group = parser.add_argument_group("GCNII Model Arguments (GCNII.py)")
    group.add_argument("--layers", type=int, default=64)
    group.add_argument("--hidden", type=int, default=64)
    group.add_argument("--alpha", type=float, default=0.1,
                       help="Weight of the initial residual h0")
    group.add_argument("--lamda", type=float, default=0.5,
                       help="λ of the identity mapping's β = ln(λ/l + 1)")
    group.add_argument("--dropout", type=float, default=0.6)
    group.add_argument("--wd1", type=float, default=0.01,
                       help="Weight decay of the convolutions (torch's "
                            "weight_decay form)")
    group.add_argument("--wd2", type=float, default=5e-4,
                       help="Weight decay of the two dense layers, biases "
                            "included (torch's weight_decay form)")
    group.add_argument("--optimizer", type=str, default="adam")
    group.add_argument("--lr", type=float, default=0.01)
    group.add_argument("--early_stopping", type=int, default=100,
                       help="Stop after this many epochs without a new best "
                            "validation loss (0 disables)")
    group.add_argument("--best_val_criteria", choices=["val_acc", "val_loss"],
                       default="val_loss")
    group.add_argument("--save_activations", action="store_true")
    group.add_argument("--save_predictions", nargs="+", type=bool, default=True)
    group.add_argument("--sparse_backend",
                       choices=["auto", "dense", "bsr", "cootile", "gscatter",
                                "segment"],
                       default="auto")
    parser.function_hooks["argparse"].append(argparse_callback)


def argparse_callback(args):
    dataset = args.objects["dataset"]
    dataset.row_normalize_features()
    support = transforms.normalize(transforms.add_eye(dataset.sparse_adj),
                                   NType.SYM_NORMALIZED)
    tensors = dataset.get_tensors(supports=[support],
                                  backend=args.sparse_backend,
                                  device=torch.device(args._device))
    args.objects["tensors"] = vars(tensors)
    model = GCNIINetwork(dataset.num_labels, layers=args.layers,
                         hidden=args.hidden, alpha=args.alpha,
                         lamda=args.lamda, dropout=args.dropout,
                         wd1=args.wd1, wd2=args.wd2)
    _runtime.initialize_model(
        args, model, args.optimizer, args.lr,
        PatienceEarlyStopping(args.early_stopping, mode="min"),
        seed=getattr(args, "random_seed", None),
    )

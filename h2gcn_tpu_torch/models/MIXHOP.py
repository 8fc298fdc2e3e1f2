"""MixHop baseline (Abu-El-Haija et al., ICML 2019).

The port of ``h2gcn_tpu.models.MIXHOP``. Each layer computes
``concat_p(Âᵖ X W_p)`` over a list of adjacency powers with per-power
capacities, then batch norm and a nonlinearity; the output layer is the
"psum" weighted segment sum with trainable softmax weights. ``--adj_pows
pow:cap1:cap2`` specs, SGD with a linear step-size decrement, and
val-accuracy patience stopping, as in the reference trainer.

The per-power SpMMs reuse one support matrix: wide inputs are projected to
each power's capacity first (``Âᵖ(x W_p)``), narrow ones chain
``Âᵖx = Â(Âᵖ⁻¹x)`` across the powers.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np
import torch
from torch import nn

from ..modules.controller import PatienceEarlyStopping
from ..nn.metrics import masked_softmax_cross_entropy
from ..nn.ops import dropout
from ..sparse import spmm, transforms
from ..sparse.transforms import NType
from . import _runtime


class AdjacencyPowersParser:
    """Parse ``--adj_pows`` like ``"0,1,2"`` or ``"0:20:10,1:10:10"``."""

    def __init__(self, spec: str):
        powers = spec.split(",")
        has_colon = None
        self._powers: List[int] = []
        self._ratios: List[List[float]] = []
        for i, p in enumerate(powers):
            if i == 0:
                has_colon = ":" in p
            elif has_colon != (":" in p):
                raise ValueError(
                    "--adj_pows: either all powers or none should include ':'"
                )
            parts = p.split(":")
            self._powers.append(int(parts[0]))
            self._ratios.append(list(map(float, parts[1:])) if has_colon else [1])

    def powers(self) -> List[int]:
        return self._powers

    def output_capacity(self, num_classes: int) -> int:
        if all(len(s) == 1 and s[0] == 1 for s in self._ratios):
            return num_classes * len(self._powers)
        return int(sum(s[-1] for s in self._ratios))

    def divide_capacity(self, layer_index: int, total_dim: int) -> List[int]:
        sizes = [r[min(layer_index, len(r) - 1)] for r in self._ratios]
        per_unit = total_dim / float(np.sum(sizes))
        dims = [int(np.round(s * per_unit)) for s in sizes[:-1]]
        dims.append(total_dim - sum(dims))
        return dims


class MixHopNetwork(nn.Module):
    """MixHop with the runtime's model interface. Parameters:
    ``kernels[j][str(p)]`` ([in, cap], a zero-capacity power keeps its
    ``[in, 0]`` kernel), ``betas[j]`` (batch norm's shift, hidden layers
    only) and ``psum_q`` (the output's segment weights)."""

    def __init__(self, powers, layer_capacities, num_classes, *,
                 l2reg=5e-4, input_dropout=0.7, layer_dropout=0.9,
                 l2_normalize=True, batch_norm=True, nonlinearity="relu",
                 psum_softmax=True):
        super().__init__()
        self.powers = list(powers)
        self.layer_capacities = [list(c) for c in layer_capacities]
        self.num_classes = num_classes
        self.l2reg = l2reg
        self.input_dropout = input_dropout
        self.layer_dropout = layer_dropout
        self.l2_normalize = l2_normalize
        self.batch_norm = batch_norm
        self.nonlinearity_name = nonlinearity
        self.nonlinearity = getattr(torch.nn.functional, nonlinearity)
        self.psum_softmax = psum_softmax
        self.kernels = nn.ModuleList()
        self.betas = nn.ParameterDict()

    @property
    def num_layers(self):
        return len(self.layer_capacities)

    def init(self, input_dim: int, num_hops: int, generator: torch.Generator,
             device="cpu") -> "MixHopNetwork":
        """Glorot-uniform kernels drawn from ``generator`` layer by layer in
        power order, zero betas and segment weights."""
        self.kernels = nn.ModuleList()
        self.betas = nn.ParameterDict()
        dim = input_dim
        for j, caps in enumerate(self.layer_capacities):
            kernels = nn.ParameterDict()
            for p, cap in zip(self.powers, caps):
                limit = np.sqrt(6.0 / (dim + cap)) if cap else 0.0
                w = (torch.rand(dim, cap, generator=generator) * 2 - 1) * limit
                kernels[str(p)] = nn.Parameter(w)
            self.kernels.append(kernels)
            dim = sum(caps)
            if self.batch_norm and j != self.num_layers - 1:
                self.betas[str(j)] = nn.Parameter(torch.zeros(dim))
        if self.psum_softmax:
            self.psum_q = nn.Parameter(torch.zeros(dim // self.num_classes))
        return self.to(device)

    def _powers_apply(self, adj, x, kernels):
        total_cap = sum(int(kernels[str(p)].shape[1]) for p in self.powers)
        if x.shape[1] > 4 * max(total_cap, 1):
            # project first: Âᵖ(x)·W_p = Âᵖ(x·W_p), aggregated at each
            # power's capacity instead of the input width
            outs = []
            for p in self.powers:
                cur = torch.matmul(x, kernels[str(p)])
                for _ in range(p):
                    cur = spmm(adj, cur)
                outs.append(cur)
            return torch.cat(outs, dim=1)
        # chain Âᵖx across the sorted powers
        outs = {}
        cur = x
        cur_pow = 0
        for p in sorted(set(self.powers)):
            while cur_pow < p:
                cur = spmm(adj, cur)
                cur_pow += 1
            outs[p] = cur
        return torch.cat([torch.matmul(outs[p], kernels[str(p)])
                          for p in self.powers], dim=1)

    def forward(self, adj, x, adjhops, *, training=False, generator=None,
                capture=None):
        support = adjhops[0] if len(adjhops) else adj
        h = dropout(x, self.input_dropout, generator, training=training)
        if self.l2_normalize:
            h = h / torch.clamp(torch.linalg.vector_norm(h, dim=1,
                                                         keepdim=True),
                                min=1e-12)
        if capture is not None:
            capture["inputs/inputs"] = x
        for j, kernels in enumerate(self.kernels):
            if j != 0:
                h = dropout(h, self.layer_dropout, generator,
                            training=training)
            h = self._powers_apply(support, h, kernels)
            if j != self.num_layers - 1:
                if self.batch_norm:
                    # the batch's own statistics in training and in
                    # evaluation (biased variance), beta only
                    mean = torch.mean(h, dim=0, keepdim=True)
                    var = torch.mean(torch.square(h - mean), dim=0,
                                     keepdim=True)
                    h = (h - mean) * torch.rsqrt(var + 1e-3)
                    h = h + self.betas[str(j)]
                h = self.nonlinearity(h)
            if capture is not None:
                capture[f"activations/{j}-mixhop"] = h
        c = self.num_classes
        if self.psum_softmax:
            q = torch.softmax(self.psum_q, dim=0)
            n_seg = self.psum_q.shape[0]
            h = sum(h[:, i * c:(i + 1) * c] * q[i] for i in range(n_seg))
        else:
            h = sum(h[:, i * c:(i + 1) * c] for i in range(h.shape[1] // c))
        if capture is not None:
            capture["activations/output-psum"] = h
        return h

    def l2_loss(self) -> torch.Tensor:
        """``l2reg · Σ‖W‖²`` over the kernels (no ½), plus the reference's
        ``1e-3 · mean(q²)`` on the segment weights."""
        total = 0.0
        for kernels in self.kernels:
            for w in kernels.values():
                total = total + torch.sum(torch.square(w))
        total = self.l2reg * total
        if self.psum_softmax:
            total = total + 1e-3 * torch.mean(torch.square(self.psum_q))
        return total

    def loss(self, logits, labels, mask) -> torch.Tensor:
        return masked_softmax_cross_entropy(logits, labels, mask) + self.l2_loss()


def load_jax_mixhop_params(model: MixHopNetwork, params) -> MixHopNetwork:
    """Load the JAX ``MixHopNetwork``'s pytree ``{"layers": [{str(p): W}],
    "bn": [{"beta"} or {}], "psum_q"}`` (numpy arrays; zero-width kernels
    included) into an initialized port model."""

    def put(dst, value, what):
        src = torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    if len(params["layers"]) != len(model.kernels):
        raise ValueError(f"{len(params['layers'])} layers for a "
                         f"{len(model.kernels)}-layer model")
    with torch.no_grad():
        for j, (layer, kernels) in enumerate(zip(params["layers"],
                                                 model.kernels)):
            if set(layer) != set(kernels.keys()):
                raise KeyError(f"layer {j}: powers {sorted(layer)} != "
                               f"{sorted(kernels.keys())}")
            for p, w in layer.items():
                put(kernels[p], w, f"layer {j} power {p}")
        for j, bn in enumerate(params.get("bn", [])):
            if "beta" in bn:
                if str(j) not in model.betas:
                    raise KeyError(f"layer {j} has no batch norm in the port")
                put(model.betas[str(j)], bn["beta"], f"layer {j} beta")
        if "psum_q" in params:
            put(model.psum_q, params["psum_q"], "psum_q")
    return model


def save_architecture(model: MixHopNetwork, path):
    """Write the architecture as JSON (the reference's
    save_architecture_to_file)."""
    spec = dict(
        powers=model.powers,
        capacities=model.layer_capacities,
        num_classes=model.num_classes,
        l2reg=model.l2reg,
        input_dropout=model.input_dropout,
        layer_dropout=model.layer_dropout,
        l2_normalize=model.l2_normalize,
        batch_norm=model.batch_norm,
        nonlinearity=model.nonlinearity_name,
        psum_softmax=model.psum_softmax,
    )
    with open(path, "w") as f:
        json.dump(spec, f, indent=2)
    return path


def load_architecture(path, num_classes=None) -> MixHopNetwork:
    with open(path) as f:
        spec = json.load(f)
    return MixHopNetwork(
        spec["powers"], spec["capacities"],
        num_classes if num_classes is not None else spec["num_classes"],
        l2reg=spec.get("l2reg", 5e-4),
        input_dropout=spec.get("input_dropout", 0.7),
        layer_dropout=spec.get("layer_dropout", 0.9),
        l2_normalize=spec.get("l2_normalize", True),
        batch_norm=spec.get("batch_norm", True),
        nonlinearity=spec.get("nonlinearity", "relu"),
        psum_softmax=spec.get("psum_softmax", True),
    )


def add_subparser_args(parser):
    group = parser.add_argument_group("MixHop Model Arguments (MIXHOP.py)")
    group.add_argument("--architecture", type=str, default="",
                       help="Path to a model-architecture JSON; overrides "
                            "the architecture flags")
    group.add_argument("--hidden_dims_csv", type=str, default="60")
    group.add_argument("--adj_pows", type=str, default="1")
    group.add_argument("--nonlinearity", type=str, default="relu")
    group.add_argument("--l2reg", type=float, default=5e-4)
    group.add_argument("--input_dropout", type=float, default=0.7)
    group.add_argument("--layer_dropout", type=float, default=0.9)
    group.add_argument("--learn_rate", type=float, default=0.5)
    group.add_argument("--lr_decrement_ratio_of_initial", type=float,
                       default=0.01)
    group.add_argument("--lr_decrement_every", type=int, default=40)
    group.add_argument("--early_stop_steps", type=int, default=50)
    group.add_argument("--optimizer", type=str, default="sgd")
    group.add_argument("--partition", choices=["mixhop", "planetoid"],
                       default="mixhop",
                       help="'mixhop' (default) trains on every node outside "
                            "the val window and the test set, as the "
                            "reference trainer does; 'planetoid' keeps the "
                            "dataset's stored masks")
    group.add_argument("--no_l2_normalization", action="store_true")
    group.add_argument("--no_batch_normalization", action="store_true")
    group.add_argument("--no_psum_output", action="store_true")
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


def linear_decrement(lr0: float, ratio: float, every: int):
    """``lr(count) = max(lr0 - ratio·lr0·(count // every), 0)`` in float32,
    ``count`` the updates already applied."""
    lr0_32 = np.float32(lr0)
    dec = np.float32(ratio * lr0)

    def schedule(count):
        return max(lr0_32 - dec * np.float32(count // every), np.float32(0))

    return schedule


def argparse_callback(args):
    dataset = args.objects["dataset"]
    if getattr(args, "partition", "mixhop") == "mixhop":
        # the reference trainer's split: train on everything outside the
        # val window and the stored test set
        dataset.set_mixhop_partition(getattr(args, "val_size", 500) or 500)
    # the support: self-looped, symmetrically normalized adjacency
    support = transforms.normalize(
        transforms.add_eye(dataset.sparse_adj), NType.SYM_NORMALIZED
    )
    tensors = dataset.get_tensors(
        supports=[support], backend=args.sparse_backend,
        reorder=(None if getattr(args, "reorder", "none") == "none"
                 else args.reorder),
        device=torch.device(args._device))
    args.objects["tensors"] = vars(tensors)

    if args.architecture:
        model = load_architecture(args.architecture,
                                  num_classes=dataset.num_labels)
    else:
        parser = AdjacencyPowersParser(args.adj_pows)
        layer_dims = [int(d) for d in args.hidden_dims_csv.split(",")]
        layer_dims.append(parser.output_capacity(dataset.num_labels))
        capacities = [parser.divide_capacity(j, d)
                      for j, d in enumerate(layer_dims)]
        model = MixHopNetwork(
            parser.powers(), capacities, dataset.num_labels,
            l2reg=args.l2reg,
            input_dropout=args.input_dropout,
            layer_dropout=args.layer_dropout,
            l2_normalize=not args.no_l2_normalization,
            batch_norm=not args.no_batch_normalization,
            nonlinearity=args.nonlinearity,
            psum_softmax=not args.no_psum_output,
        )

    schedule = linear_decrement(args.learn_rate,
                                args.lr_decrement_ratio_of_initial,
                                args.lr_decrement_every)
    if args.optimizer == "sgd":
        optimizer = lambda params: _runtime.ScheduledSGD(params, schedule)
    elif args.optimizer == "momentum":
        optimizer = lambda params: _runtime.ScheduledSGD(
            params, schedule, momentum=0.7, nesterov=True)
    else:
        optimizer = args.optimizer

    _runtime.initialize_model(
        args, model, optimizer, args.learn_rate,
        PatienceEarlyStopping(args.early_stop_steps, mode="max"),
        seed=getattr(args, "random_seed", None),
        es_metric="val_acc",
    )

    def save_arch_callback(**kwargs):
        path = Path(args.objects["checkpoint_dir"]) / "architecture.json"
        save_architecture(model, path)
        print(f"===> MixHop architecture saved to {path}")

    args.objects["pretrain_callbacks"].append(save_arch_callback)

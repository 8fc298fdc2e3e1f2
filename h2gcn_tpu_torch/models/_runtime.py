"""Shared training runtime for DSL-based models.

Builds the train / test / predict step functions for a
:class:`~h2gcn_tpu_torch.nn.model.NetworkModel` and wires the callback-based
epoch protocol: step closures in ``args.objects``, post-epoch early
stopping, best-validation selection and checkpoints, and the post-train
restore of the best state, ``results.json`` and the run store's saved
activations and predictions, and the blocked (``--epochs_per_block``)
path. The JAX package's ``_runtime`` on one device; its distributed
(``--mesh_shards``) path is not ported yet.

PyTorch updates parameters in place, so the best state is a copy
(:func:`snapshot`) where the JAX package kept a reference to an immutable
pytree.
"""

from __future__ import annotations

import copy
import json
import math
import operator

import numpy as np
import torch

from ..modules import controller, logger, monitor
from ..nn.metrics import masked_accuracy, masked_softmax_cross_entropy
from ..sparse import SparseMatrix


class KerasAdam(torch.optim.Optimizer):
    """Adam with keras's update rule.

    keras folds the bias corrections into the step size,
    ``alpha_t = lr*sqrt(1-b2^t)/(1-b1^t); p -= alpha_t * m/(sqrt(v)+eps)``,
    so its epsilon meets the uncorrected ``sqrt(v)``. ``torch.optim.Adam``
    corrects m and v first and adds eps after, which shifts the per-step
    losses away from the executed reference (the golden dynamics test).
    eps is keras's 1e-7. ``alpha_t`` is computed in float32, as the JAX
    package does. The step count is a host ``int`` per tensor, so a step
    never waits for the device.
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KerasAdam.step takes no closure")
        for group in self.param_groups:
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                st["count"] += 1
                t = torch.tensor(float(st["count"]), dtype=torch.float32)
                alpha = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
                g = p.grad
                st["m"] = b1 * st["m"] + (1.0 - b1) * g
                st["v"] = b2 * st["v"] + (1.0 - b2) * g * g
                # the float32 step size enters as a scalar operand: the same
                # product as a device copy of it, without the copy's wait
                p.add_(st["m"] * -float(alpha)
                       / (torch.sqrt(st["v"]) + eps))


class OptaxRMSprop(torch.optim.Optimizer):
    """RMSprop with ``optax.rmsprop``'s rule: ``nu = (1 - decay) g^2 +
    decay nu`` from ``nu = 0``, ``p -= lr * g / sqrt(nu + eps)`` (eps inside
    the root). ``torch.optim.RMSprop`` decays by 0.99 and adds eps outside
    the root."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxRMSprop.step takes no closure")
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                st["nu"] = (1.0 - decay) * (g * g) + decay * st["nu"]
                p.add_(torch.rsqrt(st["nu"] + eps) * g * -lr)


class OptaxAdagrad(torch.optim.Optimizer):
    """Adagrad with ``optax.adagrad``'s rule: the sum of squares starts at
    ``initial`` (0.1), ``p -= lr * g / sqrt(sum + eps)`` (eps inside the
    root). ``torch.optim.Adagrad`` starts at 0 and adds eps outside it."""

    def __init__(self, params, lr: float, initial: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial=initial, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdagrad.step takes no closure")
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum"] = torch.full_like(p, group["initial"])
                g = p.grad
                st["sum"] = g * g + st["sum"]
                scale = torch.where(st["sum"] > 0, torch.rsqrt(st["sum"] + eps),
                                    torch.zeros((), device=p.device))
                p.add_(scale * g * -lr)


class ScheduledSGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose step size follows ``schedule(count)``,
    ``count`` the updates already applied (so the first step takes
    ``schedule(0)``), as ``optax.sgd(schedule)`` does. The count lives in
    the parameter group, so checkpoints and best-state copies keep it.
    The step size is rounded to float32, the schedule's dtype in JAX."""

    def __init__(self, params, schedule, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, lr=float(np.float32(schedule(0))),
                         momentum=momentum, nesterov=nesterov)
        self.schedule = schedule
        for group in self.param_groups:
            group.setdefault("count", 0)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = float(np.float32(self.schedule(group["count"])))
            group["count"] += 1
        return super().step(closure)


# the JAX package's table (optax rules, keras's eps 1e-7), with adam's keras
# update rule
_OPTIMIZERS = {
    "adam": lambda params, lr: KerasAdam(params, lr),
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr),
    "rmsprop": lambda params, lr: OptaxRMSprop(params, lr),
    "adagrad": lambda params, lr: OptaxAdagrad(params, lr),
}


def get_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    try:
        make = _OPTIMIZERS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {name!r}; choose from {sorted(_OPTIMIZERS)}")
    return make(params, lr)


def _original_order_fn(node_perm):
    """Map per-node arrays back to the original node order.

    ``--reorder`` trains in a tile-clustered node order (``get_tensors(
    reorder=...)`` exports ``node_perm``); the returned function inverts the
    permutation on the first axis of anything with one row per node, and
    leaves other arrays as they are. The identity without a permutation.
    """
    if node_perm is None:
        return lambda a: a
    inv = torch.from_numpy(np.argsort(np.asarray(node_perm)))

    def unperm(a):
        if a.shape[:1] != inv.shape:
            return a
        if isinstance(a, torch.Tensor):
            return a[inv.to(a.device)]
        return np.asarray(a)[inv.numpy()]

    return unperm


def snapshot(model, optimizer) -> dict:
    """A copy of the training state: ``{"params", "opt_state"}``."""
    return {"params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "opt_state": copy.deepcopy(optimizer.state_dict())}


def restore(model, optimizer, state) -> None:
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["opt_state"])


def update_best_val_stats(args, epoch_stats, epoch, ckpt=None) -> bool:
    """Apply the best-val-criteria comparison and update the best record
    (ties go to the later epoch). The one rule of model selection, for the
    per-epoch protocol and the blocked loop alike."""
    op = operator.ge if args.best_val_criteria == "val_acc" else operator.le
    best = args.objects["best_val_stats"]
    if best is None or op(
        float(epoch_stats[args.best_val_criteria]),
        float(best[args.best_val_criteria]),
    ):
        new_best = dict(epoch_stats)
        new_best["epoch"] = epoch
        new_best["ckpt"] = ckpt
        args.objects["best_val_stats"] = new_best
        return True
    return False


# --------------------------------------------------------------------------
# Blocked epochs: the best state is selected on the device.
# --------------------------------------------------------------------------

# the stats of one epoch of a block, in the order of the block's table
BLOCK_STATS = ("train_loss", "train_acc", "val_acc", "test_accuracy",
               "val_loss", "test_loss")


def _where(better, new, old):
    """``new`` where the 0-d device flag ``better`` holds, else ``old``,
    for every tensor of a state tree (dicts and lists); a tensor ``old``
    lacks (the optimizer's state before its first step) takes ``new``.
    Other leaves (host ints, floats) come from ``new``: the caller
    resolves them on the host once it knows which epoch won."""
    if isinstance(new, torch.Tensor):
        return (torch.where(better, new, old)
                if isinstance(old, torch.Tensor) else new)
    if isinstance(new, dict):
        old = old if isinstance(old, dict) else {}
        return {k: _where(better, v, old.get(k)) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        old = old if isinstance(old, (list, tuple)) else ()
        return type(new)(_where(better, v, old[i] if i < len(old) else None)
                         for i, v in enumerate(new))
    return new


def _host_leaves(tree):
    """The tree with every tensor replaced by None: its structure and host
    leaves (deep-copied), kept for each epoch of a block."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return {k: _host_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_leaves(v) for v in tree)
    return copy.deepcopy(tree)


def _fill(skeleton, tensors):
    """``skeleton`` (from :func:`_host_leaves`) with its tensors taken from
    the same places of ``tensors``."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, tensors[k]) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(v, tensors[i])
                              for i, v in enumerate(skeleton))
    return tensors if skeleton is None else skeleton


def initialize_model(args, model, optimizer_name, lr, early_stopping,
                     seed=None, es_metric="val_loss"):
    """Initialize parameters and the optimizer and register the step
    functions and callbacks in ``args.objects``.

    ``optimizer_name`` is a name of :func:`get_optimizer`'s table or a
    factory ``parameters -> Optimizer``, called once the parameters exist
    (after ``model.init``). ``early_stopping`` is an int window (sliding
    mean on ``es_metric``) or a controller instance. Parameters are drawn
    from a CPU generator seeded with ``seed``; dropout (and a model's
    random draws in training) from a generator on the run's device seeded
    with ``seed + 1``.
    """
    if (getattr(args, "_mesh_shards", 0) or 0) > 1:
        raise NotImplementedError(
            "--mesh_shards: the distributed runtime is not ported yet "
            "(ROADMAP A9)")
    tensors = args.objects["tensors"]
    dataset = args.objects["dataset"]
    adj_hops = tensors.get("adj_hops", [])
    # a list of hop matrices, or the dense [n, G, n] stack of get_adj_hops
    num_hops = (len(adj_hops) if isinstance(adj_hops, (list, tuple))
                else adj_hops.shape[1]) or 1
    seed = seed if seed is not None else getattr(args, "random_seed", 123) or 123
    features = tensors["features"]
    device = (features.vals if isinstance(features, SparseMatrix)
              else features).device

    model.init(dataset.feature_dim, num_hops,
               torch.Generator().manual_seed(seed), device)
    if isinstance(optimizer_name, str):
        optimizer = get_optimizer(optimizer_name, model.parameters(), lr)
    else:
        optimizer = optimizer_name(model.parameters())
    drop_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def train(adj, adj_hops, features, y_train, train_mask, grad_monitor):
        """One training forward, backward and optimizer step; the loss as
        a 0-d device tensor."""
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(adj, features, adj_hops, training=True,
                       generator=drop_gen)
        loss = model.loss(logits, y_train, train_mask)
        # a model without trainable parameters (GCN's bp variant) has no
        # gradient to take: JAX's is zero, so its update is none
        if loss.requires_grad:
            loss.backward()
            if grad_monitor:
                monitor.grad_monitor(model)
            optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def evaluate(adj, adj_hops, features, y_train, train_mask, y_val,
                 val_mask, y_test, test_mask):
        """The logits and the stats of an evaluation, as 0-d tensors."""
        model.eval()
        logits = model(adj, features, adj_hops, training=False)
        return logits, dict(
            train_acc=masked_accuracy(logits, y_train, train_mask),
            val_acc=masked_accuracy(logits, y_val, val_mask),
            test_accuracy=masked_accuracy(logits, y_test, test_mask),
            val_loss=model.loss(logits, y_val, val_mask),
            test_loss=masked_softmax_cross_entropy(logits, y_test, test_mask),
        )

    def train_step(adj, adj_hops, features, y_train, train_mask, **kwargs):
        return dict(train_loss=train(adj, adj_hops, features, y_train,
                                     train_mask, args.grad_monitor))

    @torch.no_grad()
    def test_step(adj, adj_hops, features, y_train, train_mask, y_val,
                  val_mask, y_test, test_mask, verbose=None,
                  save_activations=False, save_predictions=False, **kwargs):
        if verbose is None:
            verbose = args.verbose
        logits, stats = evaluate(adj, adj_hops, features, y_train,
                                 train_mask, y_val, val_mask, y_test,
                                 test_mask)
        stats["monitor"] = dict()
        if args.use_signac:
            job = args.objects["signac_job"]
            unperm = _original_order_fn(kwargs.get("node_perm"))
            if save_activations:
                print("Saving activations to job data storage:")
                capture = {}
                model(adj, features, adj_hops, training=False,
                      capture=capture)
                for key, value in capture.items():
                    job.data[key] = _exportable(value, unperm)
                print(job.workspace())
            if save_predictions:
                job.data["predicted_prob"] = _exportable(logits, unperm)
                for scope, scope_mask in (
                    ("train", train_mask), ("val", val_mask), ("test", test_mask)
                ):
                    job.data[f"{scope}_mask"] = _exportable(scope_mask,
                                                            unperm)
        if args.deg_acc_monitor and verbose:
            for scope, y_scope, scope_mask in (
                ("train", y_train, train_mask),
                ("val", y_val, val_mask),
                ("test", y_test, test_mask),
            ):
                monitor.deg_acc_monitor(args, args.deg_acc_monitor, adj, logits,
                                        y_scope, scope_mask, scope,
                                        stats["monitor"])
        return stats

    @torch.no_grad()
    def predict_step(adj, adj_hops, features, **kwargs):
        model.eval()
        return model(adj, features, adj_hops, training=False)

    @torch.no_grad()
    def embed_step(adj, adj_hops, features, **kwargs):
        model.eval()
        return model.get_embeddings(adj, features, adj_hops)

    @torch.no_grad()
    def attn_step(adj, adj_hops, features, **kwargs):
        """Attention coefficients after a forward pass (GAT-style models):
        one ``[heads, edges]`` tensor a layer."""
        model.eval()
        model(adj, features, adj_hops, training=False, capture={})
        coefs = getattr(model, "last_attn_coefs", None)
        if coefs is None:
            raise NotImplementedError(
                f"{type(model).__name__} has no attention coefficients")
        return coefs

    # ---- blocked epochs (--epochs_per_block K) ---------------------------
    # K train and eval epochs with no host sync: every stat stays a 0-d
    # device tensor, the best state is selected on the device with
    # torch.where (ties to the later epoch, the criterion from -inf), and
    # the stats and each epoch's "better" flag come back in one copy at
    # the end. The optimizer's host leaves (KerasAdam's per-tensor counts,
    # a schedule's count) are kept for each epoch and resolved on the host
    # after that copy. Early stopping is replayed on the host from the
    # returned stats: when it fires mid-block, selection has seen up to
    # K-1 more epochs than the per-epoch run (the JAX package's
    # documented deviation).
    def train_block(k, start_epoch, adj, adj_hops, features, y_train,
                    train_mask, y_val, val_mask, y_test, test_mask, **kwargs):
        carry = args.objects.get("block_carry")
        if carry is None:
            carry = {"best": snapshot(model, optimizer),
                     "best_crit": torch.full((), -math.inf, device=device)}
        best, best_crit = carry["best"], carry["best_crit"]
        by_acc = args.best_val_criteria == "val_acc"
        skeletons = [_host_leaves(best["opt_state"])]
        rows = []
        for _ in range(k):
            train_loss = train(adj, adj_hops, features, y_train, train_mask,
                               False)
            _, stats = evaluate(adj, adj_hops, features, y_train, train_mask,
                                y_val, val_mask, y_test, test_mask)
            stats["train_loss"] = train_loss
            crit = stats["val_acc"] if by_acc else -stats["val_loss"]
            better = crit >= best_crit
            opt_state = optimizer.state_dict()
            best = {"params": _where(better, model.state_dict(),
                                     best["params"]),
                    "opt_state": _where(better, opt_state,
                                        best["opt_state"])}
            best_crit = torch.where(better, crit, best_crit)
            rows.append(torch.stack([stats[key].to(torch.float32)
                                     for key in BLOCK_STATS]
                                    + [better.to(torch.float32)]))
            skeletons.append(_host_leaves(opt_state))
        table = torch.stack(rows).cpu().numpy()  # the block's one readback
        won = np.flatnonzero(table[:, -1] > 0)
        # the winning epoch's host leaves (the block's start state if none
        # won) around the device-selected tensors
        best["opt_state"] = _fill(
            skeletons[won[-1] + 1 if won.size else 0], best["opt_state"])
        args.objects["block_carry"] = {"best": best, "best_crit": best_crit}
        args.objects["best_state"] = best
        return {key: table[:, i] for i, key in enumerate(BLOCK_STATS)}

    args.objects["model"] = model
    args.objects["optimizer"] = optimizer
    args.objects["train_step"] = train_step
    args.objects["test_step"] = test_step
    args.objects["predict_step"] = predict_step
    args.objects["embed_step"] = embed_step
    args.objects["attn_step"] = attn_step
    args.objects["train_block"] = train_block
    # maps predict_step's logits (or any per-node array) to the original
    # node order under --reorder
    args.objects["original_order"] = _original_order_fn(
        tensors.get("node_perm"))
    _register_protocol(args, model, optimizer, test_step, early_stopping,
                       es_metric)


def _exportable(value, unperm):
    """A captured activation, the logits or a mask as the run store keeps
    it: in the original node order, as a numpy array on the host. Sparse
    input features (a :class:`SparseMatrix`) become their CSR arrays."""
    if isinstance(value, SparseMatrix):
        csr = value.to_scipy()[unperm(np.arange(value.shape[0]))]
        return {"data": csr.data, "indices": csr.indices,
                "indptr": csr.indptr, "shape": np.asarray(csr.shape)}
    return unperm(value).detach().cpu().numpy()


def _register_protocol(args, model, optimizer, test_step, early_stopping,
                       es_metric):
    """Wire the epoch protocol: stats printing, early stopping, best-val
    tracking, checkpoint management and ``results.json``."""
    stats_printer = logger.EpochStatsPrinter()
    args.objects["statsPrinter"] = stats_printer
    args.objects["best_val_stats"] = None
    args.objects["current_ckpt"] = None
    args.objects["es_metric"] = es_metric
    if isinstance(early_stopping, int):
        args.objects["early_stopping"] = controller.SlidingMeanEarlyStopping(
            early_stopping
        )
    else:
        args.objects["early_stopping"] = early_stopping

    def post_epoch_callback(epoch, args):
        epoch_stats = args.objects["epoch_stats"]
        stats_printer(epoch, epoch_stats)

        if args.objects["early_stopping"](epoch_stats[es_metric]):
            print("Early stopping...")
            args.epochs = epoch

        every_epoch = getattr(args, "_ckpt_every_epoch", False)
        if every_epoch:
            current_ckpt = args.objects["current_ckpt"]
            best = args.objects["best_val_stats"]
            if (current_ckpt is not None and best is not None
                    and current_ckpt != best.get("ckpt")):
                logger.remove_ckpt(args, current_ckpt)
            args.objects["current_ckpt"] = logger.save_ckpt(
                snapshot(model, optimizer), args, epoch, epoch_stats
            )

        prev_best = args.objects["best_val_stats"]
        if update_best_val_stats(args, epoch_stats, epoch,
                                 ckpt=args.objects["current_ckpt"]):
            if every_epoch and prev_best is not None:
                logger.remove_ckpt(args, prev_best.get("ckpt"))
            args.objects["best_state"] = snapshot(model, optimizer)

    def post_train_callback(args):
        best = args.objects["best_val_stats"]
        if (not args.verbose) or args.save_activations or args.save_predictions:
            print("Restoring the best performance model")
            if getattr(args, "_ckpt_every_epoch", False) and best.get("ckpt"):
                state = logger.restore_ckpt(args, best["ckpt"])
            else:
                state = args.objects["best_state"]
            restore(model, optimizer, state)
            epoch_stats = test_step(
                **args.objects["tensors"], verbose=True,
                save_activations=args.save_activations,
                save_predictions=args.save_predictions,
            )
            best["monitor"] = epoch_stats["monitor"]
        final_name = logger.save_ckpt(
            snapshot(model, optimizer), args, best["epoch"], best
        )
        best.setdefault("ckpt", final_name)
        print("Best performance:")
        stats_printer.from_dict(best)
        if args.use_signac:
            record = {key: (item.item() if isinstance(
                item, (torch.Tensor, np.ndarray, np.generic)) else item)
                for key, item in best.items()}
            with open(args.objects["signac_job"].fn("results.json"), "w") as f:
                json.dump(record, f, default=str)

    args.objects["post_epoch_callbacks"].append(post_epoch_callback)
    args.objects["post_train_callbacks"].append(post_train_callback)

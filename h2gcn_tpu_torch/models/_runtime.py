"""Shared training runtime for DSL-based models.

Builds the train / test / predict step functions for a
:class:`~h2gcn_tpu_torch.nn.model.NetworkModel` and wires the callback-based
epoch protocol: step closures in ``args.objects``, post-epoch early
stopping, best-validation selection and checkpoints, and the post-train
restore of the best state, ``results.json`` and the run store's saved
activations and predictions, and the blocked (``--epochs_per_block``)
path, and the distributed runtime (``--mesh_shards``,
:func:`_initialize_distributed`). The JAX package's ``_runtime``.

PyTorch updates parameters in place, so the best state is a copy
(:func:`~h2gcn_tpu_torch.nn.blocked.snapshot`) where the JAX package kept a reference to an immutable
pytree.
"""

from __future__ import annotations

import json
import operator

import numpy as np
import torch

from .. import tracing
from ..modules import controller, logger, monitor
from ..nn.blocked import BLOCK_STATS, run_block, snapshot  # noqa: F401
from ..nn.metrics import masked_accuracy, masked_softmax_cross_entropy
from ..parallel.mesh import owns_files
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
        tracing.readback(epoch_stats[args.best_val_criteria]),
        tracing.readback(best[args.best_val_criteria]),
    ):
        new_best = dict(epoch_stats)
        new_best["epoch"] = epoch
        new_best["ckpt"] = ckpt
        args.objects["best_val_stats"] = new_best
        return True
    return False


def init_parameters(args, model, optimizer_name, lr, seed=None):
    """Draw the model's parameters on the run's device and build its
    optimizer (:func:`initialize_model`'s first half, shared by both
    runtimes). Returns ``(optimizer, device, seed)``."""
    tensors = args.objects["tensors"]
    adj_hops = tensors.get("adj_hops", [])
    # a list of hop matrices, or the dense [n, G, n] stack of get_adj_hops
    num_hops = (len(adj_hops) if isinstance(adj_hops, (list, tuple))
                else adj_hops.shape[1]) or 1
    seed = seed if seed is not None else getattr(args, "random_seed", 123) or 123
    features = tensors["features"]
    device = (features.vals if isinstance(features, SparseMatrix)
              else features).device

    with tracing.phase("setup.model_init"):
        model.init(args.objects["dataset"].feature_dim, num_hops,
                   torch.Generator().manual_seed(seed), device)
        if isinstance(optimizer_name, str):
            optimizer = get_optimizer(optimizer_name, model.parameters(), lr)
        else:
            optimizer = optimizer_name(model.parameters())
    return optimizer, device, seed


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

    ``--mesh_shards N`` > 1 registers the distributed runtime instead
    (:func:`_initialize_distributed`).
    """
    optimizer, device, seed = init_parameters(args, model, optimizer_name,
                                              lr, seed)
    mesh_shards = getattr(args, "_mesh_shards", 0) or 0
    if mesh_shards > 1:
        _initialize_distributed(args, model, optimizer, device, seed,
                                early_stopping, es_metric, mesh_shards)
        return
    tensors = args.objects["tensors"]
    drop_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def train(adj, adj_hops, features, y_train, train_mask, grad_monitor):
        """One training forward, backward and optimizer step; the loss as
        a 0-d device tensor."""
        with tracing.span("step.train"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with tracing.span("step.train.forward"):
                logits = model(adj, features, adj_hops, training=True,
                               generator=drop_gen)
            with tracing.span("step.train.loss"):
                loss = model.loss(logits, y_train, train_mask)
            # a model without trainable parameters (GCN's bp variant) has no
            # gradient to take: JAX's is zero, so its update is none
            if loss.requires_grad:
                with tracing.span("step.train.backward"):
                    loss.backward()
                if grad_monitor:
                    monitor.grad_monitor(model)
                with tracing.span("step.train.optimizer"):
                    optimizer.step()
            return loss.detach()

    @torch.no_grad()
    @tracing.traced("step.eval")
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

    # ---- blocked epochs (--epochs_per_block K): run_block ---------------
    def train_block(k, start_epoch, adj, adj_hops, features, y_train,
                    train_mask, y_val, val_mask, y_test, test_mask, **kwargs):
        def epoch():
            train_loss = train(adj, adj_hops, features, y_train, train_mask,
                               False)
            _, stats = evaluate(adj, adj_hops, features, y_train, train_mask,
                                y_val, val_mask, y_test, test_mask)
            stats["train_loss"] = train_loss
            return stats

        carry, table = run_block(model, optimizer,
                                 args.objects.get("block_carry"), k,
                                 args.best_val_criteria == "val_acc", epoch,
                                 device)
        args.objects["block_carry"] = carry
        args.objects["best_state"] = carry["best"]
        return table

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


# a rank's dropout seed: the single-device seed plus this stride a rank, so
# rank 0 draws the single-device stream (the counterpart of the JAX
# package's fold_in of the device index)
_RANK_SEED_STRIDE = 1_000_003


def _initialize_distributed(args, model, optimizer, device, seed,
                            early_stopping, es_metric, mesh_shards):
    """The distributed runtime: node-sharded tensors, edge-partitioned hops
    and the steps of :func:`h2gcn_tpu_torch.parallel.train.build_dist_steps`
    behind the same ``args.objects`` contract, on each rank of the joined
    world (:mod:`h2gcn_tpu_torch.parallel.mesh`).

    Hop-matrix models (the H2GCN and GCN families) shard per
    ``--halo_mode {ring,allgather,halo,halo-cootile}``; GAT shards its
    attention support dest-stripe-wise over the gather payload
    (:mod:`h2gcn_tpu_torch.parallel.attention`). Every rank holds the same
    parameters (drawn from the same seed) and computes; only rank 0 prints
    the epoch lines and writes checkpoints, the run store and predictions.
    Each rank's dropout draws from its own generator (seed + 1 + rank x
    :data:`_RANK_SEED_STRIDE`).
    """
    from ..parallel import dist as pdist
    from ..parallel import train as ptrain
    from ..parallel.mesh import make_mesh, owns_files
    from .GAT import GATNetwork

    tensors = args.objects["tensors"]
    hops = tensors.get("adj_hops")
    mode = getattr(args, "_halo_mode", "ring") or "ring"
    mesh = make_mesh(mesh_shards)
    if mesh.device != device:
        raise ValueError(f"--mesh_shards: the run's tensors are on {device}, "
                         f"this rank's device is {mesh.device}")

    if isinstance(model, GATNetwork):
        from ..parallel import attention as pattn

        dga, n_pad = pattn.shard_attention_gather(tensors["adj"].to_scipy(),
                                                  mesh_shards)
        model = pattn.DistGATNetwork.from_single(model)
        hop_shards = [dga]
        print(f"===> Distributed GAT: dest-stripe gather attention, "
              f"halo {dga.h_pad} rows/pair, {dga.e_pad} padded edges/shard")
    else:
        if not (isinstance(hops, (list, tuple)) and len(hops) > 0):
            raise ValueError("--mesh_shards requires hop-matrix models "
                             "(H2GCN/GCN families) or GAT")
        hop_shards, n_pad = pdist.shard_hops(
            [h.to_scipy() for h in hops], mesh_shards, mode=mode)
    drop_gen = torch.Generator(device=device).manual_seed(
        seed + 1 + mesh.rank * _RANK_SEED_STRIDE)
    train_fn, _ = ptrain.build_dist_steps(model, optimizer, mesh, hop_shards,
                                          generator=drop_gen)
    eval_full = train_fn.eval_full
    rows = ptrain.node_slice(mesh, n_pad)

    def put(key):
        value = tensors[key]
        if isinstance(value, SparseMatrix):  # sparse features
            value = value.todense()
        arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value))
        arr = pdist.pad_nodes(arr.astype(np.float32), n_pad)[rows]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    dd = {k: put(k) for k in ("features", "y_train", "train_mask", "y_val",
                              "val_mask", "y_test", "test_mask")}
    args.objects["dist_data"] = dd
    args.objects["model"] = model
    args.objects["optimizer"] = optimizer
    print(f"===> Distributed runtime: {mesh_shards}-way mesh, {mode} halo "
          f"exchange, {n_pad} padded nodes, rank {mesh.rank} on {device}")

    def train_step(**kwargs):
        return dict(train_loss=train_fn(dd["features"], dd["y_train"],
                                        dd["train_mask"]))

    n_real = args.objects["dataset"].num_samples

    def predict_step(**kwargs):
        # every rank's logits, gathered on every rank (a collective: all
        # ranks call it)
        return train_fn.logits(dd["features"])[:n_real]

    def test_step(verbose=None, save_activations=False,
                  save_predictions=False, **kwargs):
        stats = dict(eval_full(dd["features"], dd["y_train"],
                               dd["train_mask"], dd["y_val"], dd["val_mask"],
                               dd["y_test"], dd["test_mask"]))
        stats["monitor"] = dict()
        if args.use_signac and save_predictions:
            logits = predict_step()
            if owns_files():
                job = args.objects["signac_job"]
                unperm = _original_order_fn(tensors.get("node_perm"))
                job.data["predicted_prob"] = _exportable(logits, unperm)
                for scope in ("train", "val", "test"):
                    job.data[f"{scope}_mask"] = _exportable(
                        tensors[f"{scope}_mask"], unperm)
        if save_activations:
            print("===> save_activations is not supported with "
                  "--mesh_shards; skipping (run on one device for the "
                  "activation dump)")
        return stats

    def _unsupported(name):
        def step(**kwargs):
            raise NotImplementedError(
                f"{name} is not available with --mesh_shards")

        return step

    def train_block(k, start_epoch, **kwargs):
        carry, table = train_fn.block(
            args.objects.get("block_carry"), k,
            args.best_val_criteria == "val_acc", dd["features"],
            dd["y_train"], dd["train_mask"], dd["y_val"], dd["val_mask"],
            dd["y_test"], dd["test_mask"])
        args.objects["block_carry"] = carry
        args.objects["best_state"] = carry["best"]
        return table

    args.objects["train_step"] = train_step
    args.objects["test_step"] = test_step
    args.objects["train_block"] = train_block
    args.objects["predict_step"] = predict_step
    args.objects["embed_step"] = _unsupported("embed_step")
    args.objects["attn_step"] = _unsupported("attn_step")
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
    tracking, checkpoint management and ``results.json``. In a joined
    world only rank 0 prints the stats and writes files; every rank keeps
    the best state in memory."""
    writer = owns_files()
    stats_printer = logger.EpochStatsPrinter(enabled=writer)
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

    @tracing.traced("epoch.post")
    def post_epoch_callback(epoch, args):
        epoch_stats = args.objects["epoch_stats"]
        stats_printer(epoch, epoch_stats)

        if args.objects["early_stopping"](epoch_stats[es_metric]):
            print("Early stopping...")
            args.epochs = epoch

        every_epoch = writer and getattr(args, "_ckpt_every_epoch", False)
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
            if (writer and getattr(args, "_ckpt_every_epoch", False)
                    and best.get("ckpt")):
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
        if writer:
            final_name = logger.save_ckpt(
                snapshot(model, optimizer), args, best["epoch"], best
            )
            best.setdefault("ckpt", final_name)
            print("Best performance:")
        stats_printer.from_dict(best)
        if args.use_signac and writer:
            record = {key: (item.item() if isinstance(
                item, (torch.Tensor, np.ndarray, np.generic)) else item)
                for key, item in best.items()}
            with open(args.objects["signac_job"].fn("results.json"), "w") as f:
                json.dump(record, f, default=str)

    args.objects["post_epoch_callbacks"].append(post_epoch_callback)
    args.objects["post_train_callbacks"].append(post_train_callback)

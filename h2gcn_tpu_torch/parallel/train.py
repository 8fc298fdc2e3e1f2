"""Distributed full-graph training steps.

The port of ``h2gcn_tpu.parallel.train``: node-sharded activations,
replicated parameters, edge-partitioned hop matrices (or GAT's
dest-stripe attention shards), the exchange inside each aggregation, and
summed losses, metrics and gradients. Every rank takes the same optimizer
step on the same summed gradients, so the parameters stay equal on all
ranks (the cheap choice for GNN-sized models).

Each rank's loss is its share of the cross-entropy, with the mask
normalised by the all-reduced count, plus ``l2 / D``: the sum over ranks
is the global loss, and the sum of the ranks' gradients (the collectives'
backwards route cotangents to the ranks that own the activations) is the
global gradient.
"""

from __future__ import annotations

import torch

from ..nn.blocked import run_block
from ..nn.metrics import softmax_ce_rows
from . import _collectives
from .mesh import Mesh


def _normalized_mask(mask, mesh):
    m = mask.to(torch.float32)
    return m / _collectives.all_reduce(torch.sum(m), mesh)


def masked_ce_dist(logits, labels, mask, mesh: Mesh) -> torch.Tensor:
    """The global masked mean cross-entropy from each rank's rows."""
    m = _normalized_mask(mask, mesh)
    return _collectives.all_reduce(
        torch.sum(softmax_ce_rows(logits, labels) * m), mesh)


def masked_acc_dist(logits, labels, mask, mesh: Mesh) -> torch.Tensor:
    """The global masked accuracy from each rank's rows."""
    m = _normalized_mask(mask, mesh)
    correct = (torch.argmax(logits, 1)
               == torch.argmax(labels, 1)).to(torch.float32)
    return _collectives.all_reduce(torch.sum(correct * m), mesh)


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks in one collective of
    one flat buffer, with no host sync. A tensor without a gradient
    contributes zeros and keeps none: every rank runs the same graph, so
    the same tensors have gradients on every rank, and every rank's
    optimizer (KerasAdam's per-tensor counts too) sees the same state."""
    params = list(params)
    if not params:
        return
    parts = [(p.grad if p.grad is not None
              else torch.zeros_like(p)).reshape(-1) for p in params]
    flat = _collectives.all_reduce(torch.cat(parts), mesh)
    offset = 0
    for p in params:
        size = p.numel()
        if p.grad is not None:
            p.grad = flat[offset:offset + size].view_as(p)
        offset += size


def node_slice(mesh: Mesh, n_pad: int) -> slice:
    """This rank's rows of a node-sharded array (``n_pad`` rows): the
    counterpart of the JAX package's ``make_node_sharding``."""
    if n_pad % mesh.size:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size "
                         f"{mesh.size}")
    n_local = n_pad // mesh.size
    return slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)


def build_dist_steps(model, optimizer, mesh: Mesh, hop_shards,
                     generator=None):
    """The distributed steps of ``model`` (an initialized ``NetworkModel``
    or ``DistGATNetwork`` whose parameters ``optimizer`` updates) over the
    host-built ``hop_shards`` (:mod:`.dist`, :mod:`.attention`), of which
    this rank takes its own (``.local(mesh)``).

    Returns ``(train_step, eval_step)``:

    * ``train_step(x, y, mask) -> loss``: one forward, backward and
      optimizer step on every rank, the global loss as a 0-d tensor;
      dropout draws from ``generator`` (this rank's);
    * ``eval_step(x, y, mask) -> {"acc", "loss"}``;
    * ``train_step.eval_full(x, y_train, train_mask, y_val, val_mask,
      y_test, test_mask)``: the runtime's epoch stats;
    * ``train_step.logits(x)``: every rank's logits, gathered in rank order
      on every rank ([n_pad, C]);
    * ``train_step.block(carry, k, best_is_acc, x, y_train, ...)``: k
      epochs with the best state selected on the device and one stats
      readback (:func:`h2gcn_tpu_torch.nn.blocked.run_block`).

    ``x``, ``y`` and the masks are this rank's rows (:func:`node_slice`).
    Every step is a collective: all ranks call it.
    """
    hops = [h.local(mesh) for h in hop_shards]
    num_devices = mesh.size

    def forward(x, training, gen=None):
        return model(hops[0], x, hops, training=training, generator=gen)

    def train_step(x, y, mask):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = forward(x, True, generator)
        m = _normalized_mask(mask, mesh)
        partial = (torch.sum(softmax_ce_rows(logits, y) * m)
                   + model.l2_loss() / num_devices)
        if partial.requires_grad:
            partial.backward()
        all_reduce_grads(model.parameters(), mesh)
        optimizer.step()
        return _collectives.all_reduce(partial.detach().clone(), mesh)

    @torch.no_grad()
    def eval_step(x, y, mask):
        model.eval()
        logits = forward(x, False)
        return dict(acc=masked_acc_dist(logits, y, mask, mesh),
                    loss=masked_ce_dist(logits, y, mask, mesh))

    @torch.no_grad()
    def eval_full(x, y_train, train_mask, y_val, val_mask, y_test,
                  test_mask):
        model.eval()
        logits = forward(x, False)
        return dict(
            train_acc=masked_acc_dist(logits, y_train, train_mask, mesh),
            val_acc=masked_acc_dist(logits, y_val, val_mask, mesh),
            test_accuracy=masked_acc_dist(logits, y_test, test_mask, mesh),
            val_loss=masked_ce_dist(logits, y_val, val_mask, mesh)
            + model.l2_loss(),
            test_loss=masked_ce_dist(logits, y_test, test_mask, mesh),
        )

    @torch.no_grad()
    def logits_step(x):
        model.eval()
        return _collectives.gather_rows(forward(x, False), mesh)

    def block_step(carry, k, best_is_acc, x, y_train, train_mask, y_val,
                   val_mask, y_test, test_mask):
        def epoch():
            loss = train_step(x, y_train, train_mask)
            stats = eval_full(x, y_train, train_mask, y_val, val_mask,
                              y_test, test_mask)
            stats["train_loss"] = loss
            return stats

        return run_block(model, optimizer, carry, k, best_is_acc, epoch,
                         mesh.device)

    train_step.eval_full = eval_full
    train_step.logits = logits_step
    train_step.block = block_step
    return train_step, eval_step

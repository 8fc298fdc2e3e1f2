"""Blocked epochs: K training epochs with no host sync.

The training state's copy (:func:`snapshot`) and :func:`run_block`, which
runs K epochs, selects the best state on the device and reads the
block's stats back once. The one-device runtime
(:mod:`h2gcn_tpu_torch.models._runtime`) and the distributed steps
(:mod:`h2gcn_tpu_torch.parallel.train`) both build on it.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .. import tracing

def snapshot(model, optimizer) -> dict:
    """A copy of the training state: ``{"params", "opt_state"}``."""
    return {"params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "opt_state": copy.deepcopy(optimizer.state_dict())}


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


def run_block(model, optimizer, carry, k, by_acc, epoch, device):
    """K epochs of ``epoch()`` (one training step and one evaluation; it
    returns the :data:`BLOCK_STATS` as 0-d device tensors) with no host
    sync: the best state is selected on the device with ``torch.where``
    (ties to the later epoch, the criterion from -inf), and the stats and
    each epoch's "better" flag come back in one copy at the end. The
    optimizer's host leaves (KerasAdam's per-tensor counts, a schedule's
    count) are kept for each epoch and resolved on the host after that
    copy. ``carry`` is the previous block's (None: the first block).
    Returns ``(carry, {stat: [k] numpy})``; ``carry["best"]`` is the best
    state so far. Early stopping is replayed on the host from the
    returned stats: when it fires mid-block, selection has seen up to K-1
    more epochs than the per-epoch run (the JAX package's documented
    deviation)."""
    if carry is None:
        carry = {"best": snapshot(model, optimizer),
                 "best_crit": torch.full((), -math.inf, device=device)}
    best, best_crit = carry["best"], carry["best_crit"]
    skeletons = [_host_leaves(best["opt_state"])]
    rows = []
    for _ in range(k):
        stats = epoch()
        crit = stats["val_acc"] if by_acc else -stats["val_loss"]
        better = crit >= best_crit
        opt_state = optimizer.state_dict()
        best = {"params": _where(better, model.state_dict(), best["params"]),
                "opt_state": _where(better, opt_state, best["opt_state"])}
        best_crit = torch.where(better, crit, best_crit)
        rows.append(torch.stack([stats[key].to(torch.float32)
                                 for key in BLOCK_STATS]
                                + [better.to(torch.float32)]))
        skeletons.append(_host_leaves(opt_state))
    table = tracing.readback(torch.stack(rows))  # the block's one readback
    won = np.flatnonzero(table[:, -1] > 0)
    # the winning epoch's host leaves (the block's start state if none
    # won) around the device-selected tensors
    best["opt_state"] = _fill(
        skeletons[won[-1] + 1 if won.size else 0], best["opt_state"])
    return ({"best": best, "best_crit": best_crit},
            {key: table[:, i] for i, key in enumerate(BLOCK_STATS)})

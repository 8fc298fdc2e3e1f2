"""Runtime monitors: degree-binned accuracy and gradient ranges.

The degree-accuracy monitor buckets nodes by adjacency degree and reports
the masked accuracy of each bucket for a scope (and, with ``--use_signac``,
writes the bins, counts and accuracies to the job's data under
``deg_acc/<scope>/``); the gradient monitor prints each parameter's (min,
|min|, max) gradient range.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.metrics import masked_accuracy


def add_subparser_args(parser):
    group = parser.add_argument_group("Monitor arguments (modules/monitor.py)")
    group.add_argument("--deg_acc_monitor", default=[], type=float, nargs="+")
    group.add_argument("--grad_monitor", default=False, action="store_true")


def deg_acc_monitor(args, degree_bins, adj, predictions, y_sample, sample_mask,
                    sample_name, stats_dict=None):
    if stats_dict is None:
        stats_dict = dict()
    degree = torch.from_numpy(
        np.asarray(adj.to_scipy().sum(axis=1)).ravel()).to(predictions.device)
    sample_mask = sample_mask.to(torch.bool)
    prev_mask = None
    accs, counts = [], []

    def record(mask_range):
        mask_range = torch.logical_and(sample_mask, mask_range)
        accs.append(float(masked_accuracy(predictions, y_sample, mask_range)))
        counts.append(int(torch.sum(mask_range.to(torch.int32))))

    for b in degree_bins:
        deg_mask = degree <= b
        mask_range = (
            deg_mask if prev_mask is None
            else torch.logical_and(~prev_mask, deg_mask)
        )
        prev_mask = deg_mask
        record(mask_range)
    record(~prev_mask if prev_mask is not None else torch.ones_like(sample_mask))

    print(
        f"[deg_acc_monitor - {degree_bins} - {counts} - {sample_name} Acc] {accs}"
    )
    stats_dict[f"deg_acc_{sample_name}"] = dict(
        bins=list(degree_bins), counts=counts, acc=accs
    )
    if args.use_signac:
        job = args.objects["signac_job"]
        job.data[f"deg_acc/{sample_name}/bins"] = np.array(degree_bins)
        job.data[f"deg_acc/{sample_name}/counts"] = np.array(counts)
        job.data[f"deg_acc/{sample_name}/acc"] = np.array(accs)
    return stats_dict


def grad_monitor(model: torch.nn.Module):
    """Print each parameter's gradient range."""
    parts = []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach().cpu().numpy()
        parts.append(
            f"[{name}] ({g.min():.2e}, {np.abs(g).min():.2e}, {g.max():.2e})"
        )
    print("Gradient range: " + "  ".join(parts))

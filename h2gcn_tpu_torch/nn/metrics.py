"""Masked loss and accuracy: the mask is normalized to sum 1, multiplied in
elementwise and reduced by a global sum (the JAX package's semantics)."""

from __future__ import annotations

import torch


def _normalized_mask(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    return m / torch.sum(m)


def softmax_ce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy for (possibly all-zero) one-hot labels:
    ``(sum_c labels_c) * logZ - sum_c labels_c * logits_c``, exactly 0 for
    all-zero label rows."""
    logz = torch.logsumexp(logits, dim=-1)
    return torch.sum(labels, dim=-1) * logz - torch.sum(labels * logits, dim=-1)


def masked_softmax_cross_entropy(logits, labels, mask) -> torch.Tensor:
    """Mean softmax cross-entropy over the masked nodes (one-hot labels)."""
    return torch.sum(softmax_ce_rows(logits, labels) * _normalized_mask(mask))


def masked_accuracy(logits, labels, mask) -> torch.Tensor:
    """Mean argmax accuracy over the masked nodes."""
    correct = (torch.argmax(logits, dim=1)
               == torch.argmax(labels, dim=1)).to(torch.float32)
    return torch.sum(correct * _normalized_mask(mask))

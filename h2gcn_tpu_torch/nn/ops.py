"""Shared functional layer ops."""

from __future__ import annotations

import torch


def dropout(v: torch.Tensor, rate: float, generator, training: bool = True):
    """Inverted dropout drawn from ``generator`` (identity in eval mode or
    without a generator).

    The keep mask is ``rand < 1 - rate`` and kept values are scaled by
    ``1 / (1 - rate)``, as in the JAX package. The two frameworks draw
    different bits from the same seed, so parity tests run dropout-free.
    """
    if not training or generator is None or rate <= 0:
        return v
    keep = 1.0 - rate
    mask = torch.rand(v.shape, generator=generator, device=v.device) < keep
    return torch.where(mask, v / keep, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))

"""Shared functional layer ops."""

from __future__ import annotations

import dataclasses

import torch

from ..sparse import SparseMatrix


def dropout(v, rate: float, generator, training: bool = True):
    """Inverted dropout drawn from ``generator`` (identity in eval mode or
    without a generator).

    The keep mask is ``rand < 1 - rate`` and kept values are scaled by
    ``1 / (1 - rate)``, as in the JAX package. A :class:`SparseMatrix`
    (sparse features) gets the reference's sparse dropout: the mask is on
    its stored values (padding values are 0 and stay 0); only the
    ``segment`` backend is accepted, whose COO arrays are its whole payload.
    The two frameworks draw different bits from the same seed, so parity
    tests run dropout-free.
    """
    if not training or generator is None or rate <= 0:
        return v
    keep = 1.0 - rate
    if isinstance(v, SparseMatrix):
        if v.backend != "segment":
            raise ValueError(
                "sparse dropout needs the segment backend (a kernel payload "
                "would keep the undropped values); export features with "
                "backend='segment'")
        mask = torch.rand(v.vals.shape, generator=generator,
                          device=v.vals.device) < keep
        return dataclasses.replace(v, vals=torch.where(
            mask, v.vals / keep, torch.zeros((), dtype=v.vals.dtype,
                                             device=v.vals.device)))
    mask = torch.rand(v.shape, generator=generator, device=v.device) < keep
    return torch.where(mask, v / keep, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))

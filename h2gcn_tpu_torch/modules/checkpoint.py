"""Checkpoints of the training state, written with ``torch.save``.

A checkpoint is one ``ckpt.pt`` file holding ``{"params": model
state_dict, "opt_state": optimizer state_dict}`` with every tensor on the
CPU. It is read back with ``torch.load(weights_only=True)``, which unpickles
tensors and plain containers only.
"""

from __future__ import annotations

from pathlib import Path

import torch

CKPT_FILE = "ckpt.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_state(path, state) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_cpu(state), path)
    return str(path)


def load_state(path):
    """Read a checkpoint written by :func:`save_state` (tensors on the CPU)."""
    path = Path(path)
    if path.is_dir():
        path = path / CKPT_FILE
    return torch.load(path, map_location="cpu", weights_only=True)

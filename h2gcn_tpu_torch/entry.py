"""Entry points: the flagship forward step and the distributed dry run.

The port's counterpart of the JAX package's root ``__graft_entry__.py``:
:func:`entry` returns H2GCN-2's forward step with example arguments, and
:func:`dryrun_multichip` runs one distributed train and eval step in every
mode on ``n`` spawned ranks. Both run on the GPU (NCCL, one rank a GPU)
and raise where it is missing, or where ``n`` ranks need more GPUs than
the host has; ``device="cpu"`` runs them on the CPU (gloo).

    python -m h2gcn_tpu_torch.entry [N] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

_DRYRUN_MODES = ("ring", "allgather", "halo", "halo-cootile", "gat")


def _toy_problem(device, n=256, f=96, c=7, seed=0):
    import scipy.sparse as sp

    from .sparse import SparseMatrix, transforms

    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    A = ((A + A.T) > 0).astype(np.float32)
    A = transforms.remove_eye(A)
    hops = transforms.nhood_split(A, 2)
    while len(hops) < 3:
        hops.append(hops[-1])
    adj = SparseMatrix.from_scipy(A, backend="segment", device=device)
    ah = [SparseMatrix.from_scipy(transforms.normalize(h), backend="segment",
                                  device=device)
          for h in hops[1:3]]
    x = rng.standard_normal((n, f)).astype(np.float32)
    return adj, ah, x


def entry(device: str = "cuda"):
    """``(fn, example_args)``: H2GCN-2's forward step on ``device`` (the
    GPU unless ``"cpu"`` is asked for; raises where no GPU is present)
    with its parameters drawn from seed 0; ``fn(*example_args)`` is the
    logits [256, 7]."""
    import torch

    from .nn import NetworkModel, parse_network_setup
    from .run_experiments import resolve_device

    dev = resolve_device(device)
    adj, ah, x = _toy_problem(dev)
    model = NetworkModel(parse_network_setup(
        "M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO", 7, _dense_units=64,
        _dropout_rate=0.5), l2_regularize_weight=5e-4)
    model.init(x.shape[1], 2, torch.Generator().manual_seed(0), dev)

    @torch.no_grad()
    def fn(features, adj, adjhops):
        return model(adj, features, adjhops, training=False)

    return fn, (torch.from_numpy(x).to(dev), adj, ah)


def _dryrun_rank(n_devices):
    from .parallel import dryrun

    return {m: dryrun.run(n_devices, mode=m)["loss"] for m in _DRYRUN_MODES}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One distributed train and eval step of H2GCN-2 in every halo mode
    and of GAT on ``n_devices`` spawned ranks, one a GPU (``device="cpu"``:
    gloo ranks on the CPU); returns rank 0's loss of each mode. Raises
    before it spawns where the host has fewer GPUs than ranks."""
    from .parallel.mesh import spawn

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}")
    return spawn(_dryrun_rank, n_devices, device, n_devices)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(prog="python -m h2gcn_tpu_torch.entry")
    parser.add_argument("n_devices", nargs="?", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    cli = parser.parse_args(sys.argv[1:])
    fn, args = entry(cli.device)
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(cli.n_devices, cli.device)
    print("dryrun ok")

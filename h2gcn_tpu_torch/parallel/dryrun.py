"""Distributed dry run: one train step and one eval step on tiny shapes.

The port of ``h2gcn_tpu.parallel.dryrun``, used by
:func:`h2gcn_tpu_torch.entry.dryrun_multichip` and ``chip_smoke.py``. Every
rank of the world calls :func:`run`; on a process outside any world,
``run(1, ...)`` joins a world of one for the call: NCCL on the GPU (it
raises where none is present), gloo with ``device="cpu"``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def _problem(n, f, c, seed):
    import scipy.sparse as sp

    from ..sparse import transforms

    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.1, random_state=seed, format="csr")
    A = ((A + A.T) > 0).astype(np.float32)
    A = transforms.remove_eye(A)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = np.zeros((n, c), np.float32)
    y[np.arange(n), rng.integers(0, c, n)] = 1
    mask = rng.random(n) < 0.5
    return A, x, y, mask


def run(n_devices: int, n: int = 64, f: int = 32, c: int = 5, seed: int = 0,
        mode: str = "ring", device: str = "cuda"):
    """One distributed H2GCN-2 train step (``mode`` a halo mode) or GAT
    step (``mode="gat"``) and one eval step on a random graph of ``n``
    nodes; every rank returns ``{"loss", "acc", "params"}``. ``device``
    is the world of one's, where this call joins it; a joined world's
    ranks keep theirs."""
    import torch.distributed as dist

    from .mesh import check_devices, init_group

    if dist.is_initialized() or n_devices != 1:
        return _run(n_devices, n, f, c, seed, mode)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}")
    check_devices(1, device)
    with tempfile.TemporaryDirectory(prefix="h2gcn_dryrun_") as tmp:
        init_group(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0,
                   device)
        try:
            return _run(n_devices, n, f, c, seed, mode)
        finally:
            dist.destroy_process_group()


def _run(n_devices, n, f, c, seed, mode):
    from ..nn import NetworkModel, parse_network_setup
    from ..sparse import transforms
    from . import train as ptrain
    from .dist import pad_nodes, shard_hops
    from .mesh import make_mesh

    mesh = make_mesh(n_devices)
    A, x, y, mask = _problem(n, f, c, seed)
    init_gen = torch.Generator().manual_seed(seed)
    if mode == "gat":
        import scipy.sparse as sp

        from .attention import DistGATNetwork, shard_attention_gather

        support = ((A + sp.eye(n, format="csr")) > 0).astype(np.float32)
        shards, n_pad = shard_attention_gather(support, n_devices)
        shards = [shards]
        model = DistGATNetwork(c, hid_units=[8], n_heads=[2, 1],
                               in_drop=0.4, attn_drop=0.4)
        model.init(f, 1, init_gen, mesh.device)
        lr = 0.005
    else:
        hops = transforms.nhood_split(A, 2)
        while len(hops) < 3:
            hops.append(hops[-1])
        mats = [transforms.normalize(hops[1]), transforms.normalize(hops[2])]
        shards, n_pad = shard_hops(mats, n_devices, mode=mode)
        model = NetworkModel(parse_network_setup(
            "M16-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO", c, _dense_units=16,
            _dropout_rate=0.5), l2_regularize_weight=5e-4)
        model.init(f, 2, init_gen, mesh.device)
        lr = 0.01
    # optax.adam(lr, eps=1e-7), the JAX package's dry-run optimizer
    optimizer = torch.optim.Adam(model.parameters(), lr, eps=1e-7)
    gen = torch.Generator(device=mesh.device).manual_seed(1 + mesh.rank)
    train_step, eval_step = ptrain.build_dist_steps(model, optimizer, mesh,
                                                    shards, generator=gen)
    rows = ptrain.node_slice(mesh, n_pad)

    def put(a):
        a = pad_nodes(a.astype(np.float32), n_pad)[rows]
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    xd, yd, md = put(x), put(y), put(mask)
    loss = float(train_step(xd, yd, md))
    acc = float(eval_step(xd, yd, md)["acc"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite distributed loss: {loss}")
    if not 0.0 <= acc <= 1.0 + 1e-5:
        raise AssertionError(f"accuracy out of range: {acc}")
    print(f"dryrun_multichip({n_devices}, {mode}): loss={loss:.4f} "
          f"acc={acc:.3f}")
    return dict(loss=loss, acc=acc,
                params={k: v.detach().cpu()
                        for k, v in model.state_dict().items()})

"""Multi-host initialization helpers.

The port of ``h2gcn_tpu.parallel.multihost``. JAX runs one process a host
over all of its devices; torch runs one process a device, so a host runs as
many processes as it has GPUs and the 1-D mesh is the world of all of them,
ranks host-major (``torchrun --nnodes M --nproc_per_node G``), so
contiguous graph partitions share a host and the halo exchange leaves it
only at host boundaries. :func:`initialize` joins that world from explicit
arguments or from torchrun's environment.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import init_group


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, local_device_ids=None,
               device_type: str = None):
    """Join the multi-process world. A no-op if this process joined one.

    With ``coordinator_address`` (``host:port`` of rank 0), ``num_processes``
    and ``process_id`` it meets the others over ``tcp://``; with no
    arguments it reads torchrun's environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``) and, where that holds
    no world, stays a single process. ``local_device_ids`` names this
    process's GPU (one id: a process drives one device). ``device_type``
    defaults to ``cuda`` where a GPU is present (NCCL), else ``cpu``
    (gloo).
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        raise ValueError(
            "num_processes/process_id require coordinator_address")
    if coordinator_address is not None and (num_processes is None
                                            or process_id is None):
        raise ValueError(
            "coordinator_address requires num_processes and process_id")
    local_rank = None
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError("a process drives one device: pass one "
                             f"local_device_id, not {ids}")
        local_rank = int(ids[0])
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if coordinator_address is not None:
        init_group(f"tcp://{coordinator_address}", num_processes, process_id,
                   device_type, local_rank)
        return
    env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK",
                                          "MASTER_ADDR", "MASTER_PORT")}
    missing = sorted(k for k, v in env.items() if v is None)
    if missing:
        # nothing to join on a plain single-process machine
        print(f"[multihost] single-process mode (no {', '.join(missing)} "
              "in the environment)")
        return
    init_group("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
               device_type, local_rank)


def process_index() -> int:
    """This process's rank (0 outside a world)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world's size (1 outside a world)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_local_node_range(n_pad: int, num_shards: int = None):
    """This process's contiguous node range under the 1-D mesh: its
    rank's stripe of ``n_pad`` rows. ``num_shards``: the size of the mesh
    the data was sharded for (default: the world); it must divide
    ``n_pad``. A process past the mesh gets an empty range at its end."""
    n_dev = num_shards if num_shards is not None else process_count()
    if n_pad % n_dev:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {n_dev}")
    per_dev = n_pad // n_dev
    start_dev = min(process_index(), n_dev)
    end_dev = min(start_dev + 1, n_dev)
    return start_dev * per_dev, end_dev * per_dev

"""Process groups of the distributed layer: one rank a device.

The port of ``h2gcn_tpu.parallel.mesh``. JAX drives every device of its
1-D mesh from one process; ``torch.distributed`` runs one process (a rank)
a device: NCCL with one GPU a rank on the card, gloo on the CPU. A
:class:`Mesh` is this process's view of the joined world: its rank, the
world size and its device. :func:`init_group` joins a world,
:func:`spawn` starts one from a single command (the counterpart of JAX's
one process over N devices), and :func:`owns_files` says whether this
process writes the run's files (rank 0 does; every rank computes).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import tempfile

import torch
import torch.distributed as dist

# a collective that waits longer than this has lost a rank
_TIMEOUT = datetime.timedelta(minutes=30)
# seconds between the launcher's checks of its ranks
_POLL_S = 2.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of the joined world. Building one touches
    no collective; the distributed SpMMs and steps issue theirs on the
    world's default group."""

    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()


def check_devices(n_devices: int, device_type: str) -> None:
    """Raise unless this host has a GPU for each of ``n_devices`` ranks
    (NCCL takes one rank a GPU); the CPU takes any number."""
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise ValueError(f"requested {n_devices} devices, have {have}")


def init_group(init_method: str, world_size: int, rank: int,
               device_type: str, local_rank: int | None = None) -> "Mesh":
    """Join a world of ``world_size`` ranks as ``rank`` through
    ``init_method`` (``file://``, ``tcp://`` or ``env://``): NCCL on
    ``cuda:local_rank`` (made the current device, so ``--device cuda``
    tensors land there), gloo on the CPU. ``local_rank`` defaults to
    ``LOCAL_RANK`` from the environment, else ``rank``."""
    if device_type == "cuda":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
        check_devices(local_rank + 1, "cuda")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=_TIMEOUT)
    return make_mesh(world_size)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over the joined world (default: all of it). Raises when no
    process group was joined, or when ``n_devices`` is not its size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: this process joined no process group; start the "
            "ranks with --mesh_shards (the CLI spawns them), torchrun or "
            "multihost.initialize")
    size = dist.get_world_size()
    if n_devices is None:
        n_devices = size
    if n_devices != size:
        raise ValueError(f"requested {n_devices} devices, have {size}")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(rank=dist.get_rank(), size=size, device=device)


def owns_files() -> bool:
    """True in the process that writes the run's files: rank 0 of a joined
    world, or a process outside any."""
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _rank_entry(rank, world, init_method, device_type, out_path, fn, fn_args):
    """One spawned rank: join the world, run ``fn(*fn_args)``, and on rank
    0 pickle its result to ``out_path``."""
    if rank != 0:
        # rank 0 prints the run; the others compute
        sys.stdout = open(os.devnull, "w")  # noqa: SIM115: the rank's life
    if device_type == "cpu":
        # the host's cores shared between the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_group(init_method, world, rank, device_type, local_rank=rank)
    try:
        result = fn(*fn_args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, device_type: str, *fn_args):
    """Run ``fn(*fn_args)`` on ``n_ranks`` spawned ranks of a new world
    (one GPU a rank on ``cuda``, gloo on ``cpu``) and return rank 0's
    result. The ranks meet through a ``file://`` rendezvous in a fresh
    temporary directory (no port to race for). A rank that fails ends the
    others: its exception is raised here (a ``SystemExit`` with its code
    when it exited without one). Only rank 0 prints. Ranks are spawned,
    never forked: the caller may hold a CUDA context."""
    import torch.multiprocessing as mp

    check_devices(n_ranks, device_type)
    with tempfile.TemporaryDirectory(prefix="h2gcn_dist_") as tmp:
        out_path = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_entry, nprocs=n_ranks, join=False, start_method="spawn",
            args=(n_ranks, f"file://{os.path.join(tmp, 'rendezvous')}",
                  device_type, out_path, fn, fn_args))
        try:
            while not ctx.join(timeout=_POLL_S):
                pass
        except mp.ProcessExitedException as e:
            # join ended every other rank
            raise SystemExit(e.exit_code if e.exit_code and e.exit_code > 0
                             else 1) from e
        with open(out_path, "rb") as f:
            return pickle.load(f)

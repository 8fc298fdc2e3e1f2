"""Multi-device and host-parallel execution.

The port of ``h2gcn_tpu.parallel`` on ``torch.distributed``: process groups
(:mod:`.mesh`), the distributed SpMM in four halo modes (:mod:`.dist`), the
distributed training steps (:mod:`.train`), dest-stripe GAT
(:mod:`.attention`), multi-host set-up (:mod:`.multihost`), the dry run
(:mod:`.dryrun`), and the row-sharded exact-hop precompute on host workers
(:mod:`.spgemm`). The names below resolve lazily, so importing this
package imports nothing else: the spgemm's spawned workers import it, and
stay off torch.
"""

__all__ = [
    "DistSparseMatrix", "HaloCooTileMatrix", "HaloShardedMatrix",
    "RingShardedMatrix", "ShardedMatrix", "dist_spmm", "dist_spmm_halo",
    "dist_spmm_halo_cootile", "dist_spmm_ring", "shard_hops",
    "shard_matrix", "shard_matrix_halo", "shard_matrix_halo_cootile",
    "shard_matrix_ring", "make_mesh",
]


def __getattr__(name):  # PEP 562: lazy re-exports
    import importlib

    if name == "make_mesh":
        from .mesh import make_mesh

        return make_mesh
    if name in __all__:
        from . import dist as _dist

        return getattr(_dist, name)
    try:
        return importlib.import_module(f".{name}", __name__)
    except ModuleNotFoundError:
        raise AttributeError(name) from None

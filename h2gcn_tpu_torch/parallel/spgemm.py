"""Row-sharded exact-hop neighborhood precompute (boolean SpGEMM over P
host workers).

The port's copy of ``h2gcn_tpu.parallel.spgemm``, on the port's native
library (:mod:`h2gcn_tpu_torch.native`). It is host code with no device and
no collective: ``--precompute_workers N`` routes H2GCN's exact-hop split
through it (``transforms.nhood_split(..., n_workers=N)``).

The reference computes Â₂ with a full-matrix scipy spgemm on one host
(reference h2gcn/datasets/_dataset.py:139-158). This module row-shards the
reachability relation across P workers and expands each shard's frontier
independently:

* The base relation ``R₁ = A + I`` is row-partitioned into P contiguous
  shards; worker ``p`` owns rows ``[lo_p, hi_p)`` for the whole run.
* One expansion round computes ``R_{t+1}[lo:hi] = R_t[lo:hi] ⊙ R₁``
  (boolean product). Worker ``p`` only needs the R₁ rows named by the
  columns of its current shard, its **frontier halo**. The halo row and
  byte volumes are measured per shard and round (:class:`SpgemmStats`), so
  the traffic a multi-host layout would ship is a number, not a claim.
* Exact-hop extraction ``hop_{t+1} = R_{t+1} ∖ R_t`` happens on the still
  row-sharded results; only the final hop matrices are concatenated.

Two transports:

* ``"threads"`` (default): P Python threads each run the native kernel,
  which releases the GIL, against the shared ``R₁`` with ``ncpu//P`` OpenMP
  lanes apiece (no halo extraction, no serialization; the halo volumes are
  still measured).
* ``"processes"``: the coordinator extracts and ships each worker's halo
  to a pool of spawned processes, so a worker holds only its shard and
  halo. For validating that layout and measuring its serialization cost;
  not a single-host performance path.

Output contract is that of
:func:`h2gcn_tpu_torch.sparse.transforms.nhood_split` (``[I, A₁ᵉˣ, A₂ᵉˣ,
...]``, stopping early when reachability stops growing), entry for entry.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

_EXECUTOR_THREADS = "1"  # one OpenMP lane per worker → clean scaling numbers


@dataclass
class SpgemmStats:
    """Measured communication/compute volumes of one distributed run."""

    n_workers: int
    rounds: int = 0
    halo_rows: List[List[int]] = field(default_factory=list)   # per round, per shard
    halo_bytes: List[List[int]] = field(default_factory=list)
    shard_nnz: List[List[int]] = field(default_factory=list)

    @property
    def total_halo_bytes(self) -> int:
        return int(sum(sum(r) for r in self.halo_bytes))


def _init_worker():
    os.environ["OMP_NUM_THREADS"] = _EXECUTOR_THREADS


def _expand_shard(r_indptr, r_indices, n_cols, needed, b_indptr, b_indices):
    """One worker task: compacted-halo boolean product for one row shard.

    ``needed`` are the global ids of the halo rows, ``b_*`` the CSR arrays of
    ``R₁[needed]``. Returns the expanded shard's CSR arrays (global columns).
    """
    from ..native import bool_spgemm

    rows = len(r_indptr) - 1
    local_cols = np.searchsorted(needed, r_indices).astype(np.int32)
    a_local = sp.csr_matrix(
        (np.ones(len(r_indices), np.float32), local_cols, r_indptr),
        shape=(rows, max(len(needed), 1)),
    )
    b_local = sp.csr_matrix(
        (np.ones(len(b_indices), np.float32), b_indices, b_indptr),
        shape=(max(len(needed), 1), n_cols),
    )
    c = bool_spgemm(a_local, b_local)
    return c.indptr, c.indices


def _expand_shard_shared(r_shard, base, n_threads):
    """Thread-transport worker: boolean product straight against the shared
    ``R₁`` (no halo extraction — shared memory is the interconnect), with a
    capped OpenMP team so P concurrent workers don't oversubscribe. Returns
    the expanded shard plus the halo volume a multi-host layout would ship."""
    from ..native import bool_spgemm

    needed = np.unique(r_shard.indices)
    halo_nnz = int(np.diff(base.indptr)[needed].sum()) if needed.size else 0
    halo_bytes = int(needed.size * 8 + halo_nnz * 4 + (needed.size + 1) * 8)
    c = bool_spgemm(r_shard, base, num_threads=n_threads)
    return c, int(needed.size), halo_bytes


def dist_nhood_split(
    adj: sp.spmatrix,
    nhood: int,
    n_workers: int = 1,
    return_stats: bool = False,
    pool: Optional[ProcessPoolExecutor] = None,
    transport: str = "threads",
):
    """Row-sharded exact-hop split ``[I, A₁ᵉˣ, ..., A_kᵉˣ]`` over P workers.

    ``n_workers=1`` runs the same sharded algorithm in-process (useful for
    validation); ``pool`` lets a caller amortize executor startup over
    multiple graphs (process transport only). See the module docstring for
    the ``transport`` contract.
    """
    assert adj.ndim == 2 and adj.shape[0] == adj.shape[1]
    n = adj.shape[0]
    base = (sp.csr_matrix(adj) + sp.eye(n, format="csr", dtype=adj.dtype)).tocsr()
    base.sort_indices()

    bounds = np.linspace(0, n, n_workers + 1).astype(np.int64)
    shards = [base[bounds[p]:bounds[p + 1]] for p in range(n_workers)]

    stats = SpgemmStats(n_workers=n_workers)
    out = [sp.eye(n, format="csr", dtype=np.float32)]
    if transport == "threads" and pool is None:
        return _dist_nhood_split_threads(
            n, base, bounds, shards, nhood, n_workers, stats, out,
            return_stats)
    own_pool = None
    if n_workers > 1 and pool is None:
        # spawn (not fork): the parent may hold a CUDA context and warm
        # OpenMP pools, neither of which survives fork safely. Workers stay
        # off the device entirely (host spgemm only).
        import multiprocessing as mp

        own_pool = ProcessPoolExecutor(
            max_workers=n_workers, initializer=_init_worker,
            mp_context=mp.get_context("spawn"),
        )
        pool = own_pool

    try:
        from ..native import bool_subtract

        # R_t = (A+I)^t is CUMULATIVE reachability (self loops), so the
        # exact hop-t set is simply R_t ∖ R_{t-1} — same recurrence as
        # transforms.nhood_split (reference _dataset.py:139-158).
        prev_shards = [
            sp.eye(n, format="csr",
                   dtype=np.float32)[bounds[p]:bounds[p + 1]].tocsr()
            for p in range(n_workers)
        ]
        # starts at 0 (not nnz(I)) so hop 1 never early-breaks — matching
        # transforms.nhood_split, which appends an EMPTY hop-1 matrix for an
        # edgeless graph rather than stopping before it
        edge_sum = 0.0
        for hop in range(1, nhood + 1):
            if hop == 1:
                cur_shards = shards  # I ⊙ R₁ = R₁ — no expansion round
            else:
                tasks, halo_rows, halo_bytes = [], [], []
                for r_shard in cur_shards:
                    needed = np.unique(r_shard.indices)
                    b_halo = base[needed]
                    halo_rows.append(int(needed.size))
                    halo_bytes.append(
                        int(needed.size * 8 + b_halo.indices.nbytes
                            + b_halo.indptr.nbytes)
                    )
                    tasks.append((r_shard.indptr, r_shard.indices, n, needed,
                                  b_halo.indptr, b_halo.indices))
                stats.halo_rows.append(halo_rows)
                stats.halo_bytes.append(halo_bytes)
                stats.rounds += 1
                if pool is not None:
                    results = list(pool.map(_expand_shard, *zip(*tasks)))
                else:
                    results = [_expand_shard(*t) for t in tasks]
                prev_shards = cur_shards
                cur_shards = [
                    sp.csr_matrix(
                        (np.ones(len(ix), np.float32), ix, ip),
                        shape=(len(ip) - 1, n),
                    )
                    for ip, ix in results
                ]
            new_edge_sum = float(sum(c.nnz for c in cur_shards))
            if new_edge_sum == edge_sum:
                break  # reachability saturated — same contract as nhood_split
            edge_sum = new_edge_sum

            diff_parts = [
                bool_subtract(cur, prv)
                for cur, prv in zip(cur_shards, prev_shards)
            ]
            stats.shard_nnz.append([int(d.nnz) for d in diff_parts])
            out.append(sp.vstack(diff_parts).tocsr())
            prev_shards = cur_shards
    finally:
        if own_pool is not None:
            own_pool.shutdown()

    return (out, stats) if return_stats else out


def _dist_nhood_split_threads(n, base, bounds, shards, nhood, n_workers,
                              stats, out, return_stats):
    """Thread-transport body: same sharded recurrence, shared-memory R₁."""
    from concurrent.futures import ThreadPoolExecutor

    from ..native import bool_subtract

    lanes = max(1, (os.cpu_count() or 1) // n_workers)
    prev_shards = [
        sp.eye(n, format="csr",
               dtype=np.float32)[bounds[p]:bounds[p + 1]].tocsr()
        for p in range(n_workers)
    ]
    edge_sum = 0.0
    cur_shards = None
    with ThreadPoolExecutor(max_workers=n_workers) as tp:
        for hop in range(1, nhood + 1):
            if hop == 1:
                cur_shards = shards  # I ⊙ R₁ = R₁ — no expansion round
            else:
                results = list(tp.map(
                    lambda r: _expand_shard_shared(r, base, lanes),
                    cur_shards))
                prev_shards = cur_shards
                cur_shards = [r[0] for r in results]
                stats.halo_rows.append([r[1] for r in results])
                stats.halo_bytes.append([r[2] for r in results])
                stats.rounds += 1
            new_edge_sum = float(sum(c.nnz for c in cur_shards))
            if new_edge_sum == edge_sum:
                break  # reachability saturated — same contract as nhood_split
            edge_sum = new_edge_sum

            diff_parts = list(tp.map(
                lambda cp: bool_subtract(cp[0], cp[1]),
                zip(cur_shards, prev_shards)))
            stats.shard_nnz.append([int(d.nnz) for d in diff_parts])
            out.append(sp.vstack(diff_parts).tocsr())
            prev_shards = cur_shards
    return (out, stats) if return_stats else out

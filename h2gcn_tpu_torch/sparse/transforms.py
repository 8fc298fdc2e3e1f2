"""Host-side graph transforms (scipy), the port's copy of
``h2gcn_tpu.sparse.transforms``.

Symmetric / random-walk normalization with the inf->0 degree guard, diagonal
add/remove, row normalization of features, the exact-k-hop split used by
H2GCN (A_k = 1[(A+I)^k > 0] - 1[(A+I)^(k-1) > 0]), the Chebyshev polynomial
supports of GCN-Cheby, and the tile-clustering node order
(``cluster_order``, ``permute_graph``). Everything here runs once
per dataset on the host; results become
:class:`~h2gcn_tpu_torch.sparse.matrix.SparseMatrix` objects on the device.
"""

from __future__ import annotations

from enum import Enum
from typing import List

import numpy as np
import scipy.sparse as sp


class NType(Enum):
    ORDINARY = 0
    SYM_NORMALIZED = 1
    RW_NORMALIZED = 2
    CHEBY = 3


def normalize(adj: sp.spmatrix, ntype: NType = NType.SYM_NORMALIZED) -> sp.spmatrix:
    """D^{-1/2} A D^{-1/2} (SYM) or D^{-1} A (RW), zero-degree guarded."""
    if ntype == NType.ORDINARY:
        return adj
    deg = np.asarray(adj.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        if ntype == NType.SYM_NORMALIZED:
            d = np.power(deg, -0.5)
            d[np.isinf(d)] = 0.0
            D = sp.diags(d)
            return D @ adj @ D
        elif ntype == NType.RW_NORMALIZED:
            d = np.power(deg, -1.0)
            d[np.isinf(d)] = 0.0
            return sp.diags(d) @ adj
    raise ValueError(f"Unsupported normalization {ntype}")


def add_eye(adj: sp.spmatrix) -> sp.csr_matrix:
    """Set the diagonal to 1."""
    out = adj.tolil(copy=True)
    out.setdiag(1)
    return out.tocsr()


def remove_eye(adj: sp.spmatrix) -> sp.csr_matrix:
    """Zero the diagonal."""
    out = adj.tolil(copy=True)
    out.setdiag(0)
    out = out.tocsr()
    out.eliminate_zeros()
    return out


def nhood_split(adj: sp.spmatrix, nhood: int,
                use_native: bool = True,
                n_workers: int = 1) -> List[sp.spmatrix]:
    """Exact-hop reachability split ``[I, A1, A2, ...]``.

    ``A_k[i,j] = 1`` iff the shortest path between i and j (allowing the
    self loop added each round) is exactly k. Stops early when the reachable
    set stops growing. With the native library (:mod:`h2gcn_tpu_torch.native`)
    the boolean spgemm runs in its OpenMP C++ path, else in scipy.
    ``n_workers > 1`` runs the row-sharded precompute over that many host
    workers instead (:func:`h2gcn_tpu_torch.parallel.spgemm.dist_nhood_split`),
    with the same result.
    """
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"nhood_split needs a square matrix, got {adj.shape}")
    if isinstance(nhood, float) and np.isnan(nhood):
        return [sp.csr_matrix(np.ones(adj.shape))]
    if n_workers > 1:
        from ..parallel.spgemm import dist_nhood_split

        return dist_nhood_split(adj, nhood, n_workers=n_workers)
    if use_native:
        from .. import native

        if native.available():
            return native.nhood_split_fast(sp.csr_matrix(adj), nhood)
    n = adj.shape[0]
    a_plus_i = (adj + sp.eye(n, format="csr")).tocsr()
    mt = sp.eye(n, format="csr")
    out = [mt]
    edge_sum = 0
    i = 0
    while i < nhood:
        prev = mt
        mt = mt @ a_plus_i
        mt = (mt > 0).astype(adj.dtype)
        new_edge_sum = mt.sum()
        if new_edge_sum == edge_sum:
            break
        edge_sum = new_edge_sum
        i += 1
        diff = (mt - prev).tocsr()
        diff.eliminate_zeros()
        out.append(diff)
    return out


def cluster_order(pattern: sp.spmatrix, method: str = "cluster",
                  hub_quantile: float = 0.99) -> np.ndarray:
    """Node permutation that packs edges into few tiles.

    ``"rcm"``: reverse Cuthill-McKee. ``"cluster"``: the nodes of degree at
    or above the ``hub_quantile`` quantile (the power-law hubs that touch
    almost every tile) first, by descending degree, then the residual graph
    in RCM order. Returns ``perm`` (int32[n]): new position ``i`` holds old
    node ``perm[i]``; apply with ``A[perm][:, perm]`` and ``x[perm]``.
    """
    from .. import native

    csr = sp.csr_matrix(pattern)
    if method == "rcm":
        return native.rcm_order(csr)
    if method != "cluster":
        raise ValueError(f"unknown reorder method {method!r}")
    deg = np.diff(csr.indptr)
    thresh = np.quantile(deg, hub_quantile)
    hubs = np.where(deg >= max(thresh, 1))[0]
    rest = np.where(deg < max(thresh, 1))[0]
    if hubs.size == 0 or rest.size == 0:
        return native.rcm_order(csr)
    sub = csr[rest][:, rest].tocsr()
    return np.concatenate([
        hubs[np.argsort(-deg[hubs], kind="stable")].astype(np.int32),
        rest[native.rcm_order(sub)].astype(np.int32),
    ])


def permute_graph(mat: sp.spmatrix, perm: np.ndarray) -> sp.csr_matrix:
    """Symmetric permutation ``P A P^T`` of a square sparse matrix."""
    return sp.csr_matrix(mat)[perm][:, perm].tocsr()


def row_normalize(features: sp.spmatrix):
    """Row-normalize a (sparse) feature matrix; zero rows stay zero."""
    rowsum = np.asarray(features.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        inv = np.power(rowsum, -1.0)
    inv[np.isinf(inv)] = 0.0
    return sp.diags(inv) @ features


def chebyshev_polynomials(adj: sp.spmatrix, k: int,
                          eigenvalue=None) -> List[sp.spmatrix]:
    """Chebyshev polynomial supports T_0..T_k of the scaled Laplacian
    ``2 L / lambda_max - I``, ``L = I - D^{-1/2} A D^{-1/2}``.

    ``eigenvalue=None`` computes the largest Laplacian eigenvalue with
    ARPACK; where ARPACK does not converge (disconnected or near-bipartite
    graphs) it warns and takes 2, the bound of a normalized Laplacian's
    spectrum. Pass ``2`` for the fixed-eigenvalue variant. The T_k are
    scipy CSR in the JAX package's order of operations, so their patterns
    (explicit zeros included) and values are the same.
    """
    n = adj.shape[0]
    adj_normalized = normalize(sp.csr_matrix(adj), NType.SYM_NORMALIZED)
    laplacian = sp.eye(n) - adj_normalized
    if eigenvalue is None:
        from scipy.sparse.linalg import ArpackNoConvergence, eigsh

        try:
            largest, _ = eigsh(laplacian, 1, which="LM")
            largest = largest[0]
        except ArpackNoConvergence:
            import warnings

            warnings.warn("ARPACK did not converge on the Laplacian; "
                          "falling back to eigenvalue=2")
            largest = 2.0
    else:
        largest = eigenvalue
    scaled_lap = (2.0 / largest) * laplacian - sp.eye(n)

    t_k = [sp.eye(n).tocsr(), sp.csr_matrix(scaled_lap)]
    for _ in range(2, k + 1):
        t_k.append(2 * scaled_lap @ t_k[-1] - t_k[-2])
    return t_k

"""Graph statistics registry.

The reference computes these with per-edge Python loops over a networkx
graph (experiments/h2gcn/modules/graph_stats.py:6-145); here every statistic
is a vectorized scipy/numpy computation over the CSR adjacency + label
array. Same registry contract: ``stats_dict`` maps
``name → (func, add_to_doc, add_to_data)``.

Inputs: ``adj`` (scipy CSR, binary, symmetric), ``colors`` (1-based labels,
0 = unlabeled), ``ally`` (one-hot label matrix), optional ``statepoint``
(for the theoretical mixing matrix of mixhop-generated graphs).

The port's own copy of ``h2gcn_tpu.experiments.graph_stats``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from .graphgen import MixhopGraphGenerator


def _edge_list(adj, keep_diag=False):
    coo = sp.triu(adj, k=0 if keep_diag else 1).tocoo()
    return coo.row, coo.col


def getHomoEdgeRatio(adj, colors, **kw):
    # self loops included, like the reference's G.edges() iteration
    u, v = _edge_list(adj, keep_diag=True)
    labeled = (colors[u] > 0) & (colors[v] > 0)
    total = labeled.sum()
    same = ((colors[u] == colors[v]) & labeled).sum()
    ratio = float(same) / float(total) if total else 0.0
    return {"homoEdgeRatio": ratio}


def getGeomGCNBeta(adj, colors, **kw):
    """Mean over labeled nodes of (same-label neighbor fraction)."""
    labeled = (colors > 0).astype(np.float64)
    n_classes = int(colors.max())
    onehot = np.zeros((len(colors), n_classes))
    idx = np.nonzero(colors > 0)[0]
    onehot[idx, colors[idx] - 1] = 1
    same_count = np.asarray(
        (adj @ onehot)[np.arange(len(colors)),
                       np.maximum(colors - 1, 0)]
    ).ravel()
    labeled_deg = np.asarray(adj @ labeled).ravel()
    valid = (colors > 0) & (labeled_deg > 0)
    beta = same_count[valid] / labeled_deg[valid]
    return {"GeomGCNBeta": float(beta.mean())}


def getClassSize(ally=None, **kw):
    return {"classSize": np.sum(ally, axis=0)}


def getDegrees(adj, **kw):
    degrees = np.asarray(adj.sum(axis=1)).ravel()
    sorted_degree = np.sort(degrees)[::-1]
    return {
        "sorted_degree": sorted_degree,
        "avg_degree": float(np.mean(degrees)),
        "min_degree": float(sorted_degree[-1]),
        "max_degree": float(sorted_degree[0]),
        "quantile_degree": np.quantile(
            sorted_degree, [0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1]
        ),
    }


def getNumNodeEdges(adj, **kw):
    return {
        "numEdges": int(sp.triu(adj, k=1).nnz + adj.diagonal().sum()),
        "numNodes": adj.shape[0],
    }


def getTriangleCounts(adj):
    a = adj.copy()
    a.setdiag(0)
    a.eliminate_zeros()
    tri2 = (a @ a).multiply(a).sum(axis=1)  # 2 × triangles per node
    return np.asarray(tri2).ravel() / 2.0


def getAvgCC(adj, **kw):
    tri = getTriangleCounts(adj)
    deg = np.asarray(adj.sum(axis=1)).ravel() - adj.diagonal()
    possible = deg * (deg - 1) / 2.0
    local = np.where(possible > 0, tri / np.maximum(possible, 1), 0.0)
    return {"avgClusteringCoeff": float(local.mean())}


def getNumTriangles(adj, **kw):
    tri = getTriangleCounts(adj)
    return {
        "numTriangles": tri.astype(np.int64),
        "numTotalTriangles": int(tri.sum() // 3),
    }


def getNumComponents(adj, **kw):
    n, _ = csgraph.connected_components(adj, directed=False)
    return {"numComponents": int(n)}


def getAvgShortestPath(adj, **kw):
    """Pair-count-weighted mean shortest path, computed per connected
    component (full-graph shortest_path would allocate an n² matrix)."""
    n_comp, labels = csgraph.connected_components(adj, directed=False)
    adj = sp.csr_matrix(adj)
    pair_count = 0
    dist_count = 0.0
    for c in range(n_comp):
        nodes = np.nonzero(labels == c)[0]
        if len(nodes) < 2:
            continue
        sub_adj = adj[np.ix_(nodes, nodes)]
        sub = csgraph.shortest_path(sub_adj, method="D", unweighted=True,
                                    directed=False)
        finite = np.isfinite(sub)
        np.fill_diagonal(finite, False)
        pair_count += finite.sum()
        dist_count += sub[finite].sum()
    return {"avgSPLength": dist_count / pair_count if pair_count else 0.0}


def getMatrixH(statepoint=None, **kw):
    if statepoint and statepoint.get("method") == "mixhop":
        gen = MixhopGraphGenerator(
            statepoint["classRatio"], statepoint.get("heteroClsWeight",
                                                     "circularDist"),
            hetero_weights_exponent=statepoint.get("heteroWeightsExponent", 1.0),
        )
        return {"H": gen.getH(statepoint["h"])}
    return {"H": None}


def getEmpiricalH(adj, colors, ally, **kw):
    u, v = _edge_list(adj)
    n_classes = ally.shape[1]
    eH = np.zeros((n_classes, n_classes))
    labeled = (colors[u] > 0) & (colors[v] > 0)
    ul = colors[u[labeled]] - 1
    vl = colors[v[labeled]] - 1
    np.add.at(eH, (ul, vl), 1)
    np.add.at(eH, (vl, ul), 1)
    cH = eH.copy()
    with np.errstate(invalid="ignore"):
        eH = eH / eH.sum(1, keepdims=True)
    return {"cH": cH, "eH": eH}


def getDataQuality(adj, ally, **kw):
    return {
        "numSelfLoops": int(adj.diagonal().sum()),
        "numNoLabel": int(np.sum(ally.sum(1) < 1)),
    }


stats_dict = {
    # <name>: (<func>, <add_to_job_doc>, <add_to_job_data>)
    "homoEdgeRatio": (getHomoEdgeRatio, True, True),
    "classSize": (getClassSize, True, True),
    "sorted_degree": (getDegrees, False, True),
    "avg_degree": (getDegrees, True, True),
    "min_degree": (getDegrees, True, True),
    "max_degree": (getDegrees, True, True),
    "numEdges": (getNumNodeEdges, True, True),
    "numNodes": (getNumNodeEdges, True, True),
    "avgClusteringCoeff": (getAvgCC, True, True),
    "avgSPLength": (getAvgShortestPath, True, True),
    "numComponents": (getNumComponents, True, True),
    "numTriangles": (getNumTriangles, False, True),
    "numTotalTriangles": (getNumTriangles, True, True),
    "GeomGCNBeta": (getGeomGCNBeta, True, True),
    "H": (getMatrixH, False, True),
    "eH": (getEmpiricalH, False, True),
    "cH": (getEmpiricalH, False, True),
    "numSelfLoops": (getDataQuality, True, True),
    "numNoLabel": (getDataQuality, True, True),
    "quantile_degree": (getDegrees, True, True),
}


def calculate_statistics(adj, colors, ally, statepoint=None,
                         stats=None):
    """Run the registry once, deduplicating shared functions."""
    wanted = stats if stats is not None else list(stats_dict)
    results = {}
    done_funcs = {}
    for name in wanted:
        func = stats_dict[name][0]
        if func not in done_funcs:
            done_funcs[func] = func(adj=adj, colors=colors, ally=ally,
                                    statepoint=statepoint)
        results[name] = done_funcs[func][name]
    return results

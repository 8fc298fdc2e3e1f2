"""The traffic generator: one graph a run, made from ``--seed`` at a public
dataset's published counts.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters;
this one generator reads every such file:

- ``nodes``, ``edges``: the node count and the number of distinct
  undirected edges (no self loops). Endpoints are drawn with probability
  proportional to ``(i + 1) ** -degree_exponent`` (the degree law of the
  repository's ``bench.py``) from ``graph_seed``, and the first ``edges``
  distinct pairs in draw order are kept. ``--seed`` then relabels the
  nodes by a permutation it draws: every seed gives the same graph in
  another order, so every size the program derives from it (the exact
  2-hop matrix's entries, the attention edges) is the same from seed to
  seed;
- ``features`` and ``feature_kind``: ``binary`` (bag of words, exactly
  ``feature_nnz_per_row`` ones a row) or ``uniform`` (dense, in [0, 1));
- ``classes``: labels balanced over the classes, in a seeded order;
- ``split``: ``per_class`` (each class split ``train`` / ``val`` / rest,
  H2GCN's rule) or ``random`` (all nodes together).

Numpy only: the benchmark's reference and the program both read what this
makes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Graph:
    n: int
    src: np.ndarray          # [E] int64: each undirected edge once
    dst: np.ndarray          # [E] int64
    features: object         # scipy CSR (binary) or a dense float32 array
    labels: np.ndarray       # [n] int64
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    classes: int

    def adjacency(self) -> sp.csr_matrix:
        """The symmetric binary adjacency, float32 CSR, sorted indices."""
        r = np.concatenate([self.src, self.dst])
        c = np.concatenate([self.dst, self.src])
        a = sp.csr_matrix((np.ones(r.size, np.float32), (r, c)),
                          shape=(self.n, self.n))
        a.sort_indices()
        return a

    def dense_features(self) -> np.ndarray:
        f = self.features
        return (f.toarray() if sp.issparse(f) else f).astype(np.float32)


def _edges(rng, n: int, m: int, exponent: float):
    w = (np.arange(n) + 1.0) ** -exponent
    w /= w.sum()
    keys = np.empty(0, np.int64)
    draw = int(m * 1.25) + 1024
    while True:
        src = rng.choice(n, size=draw, p=w)
        dst = rng.choice(n, size=draw, p=w)
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        new = (lo * n + hi)[lo != hi]
        keys = np.concatenate([keys, new])
        uniq, first = np.unique(keys, return_index=True)
        if uniq.size >= m:
            kept = keys[np.sort(first)[:m]]
            return kept // n, kept % n
        draw *= 2


def _split(rng, labels, classes, split):
    kind = split["kind"]
    groups = ([np.nonzero(labels == c)[0] for c in range(classes)]
              if kind == "per_class" else [np.arange(labels.size)])
    if kind not in ("per_class", "random"):
        raise ValueError(f"unknown split kind {kind!r}")
    parts = ([], [], [])
    for idx in groups:
        idx = idx[rng.permutation(idx.size)]
        n_tr = int(round(split["train"] * idx.size))
        n_va = int(round(split["val"] * idx.size))
        parts[0].append(idx[:n_tr])
        parts[1].append(idx[n_tr:n_tr + n_va])
        parts[2].append(idx[n_tr + n_va:])
    return tuple(np.sort(np.concatenate(p)).astype(np.int64) for p in parts)


def generate(traffic: dict, seed: int) -> Graph:
    """The graph of ``traffic`` for ``seed`` (any non-negative integer)."""
    n, classes = int(traffic["nodes"]), int(traffic["classes"])
    src, dst = _edges(np.random.default_rng(int(traffic["graph_seed"])), n,
                      int(traffic["edges"]), float(traffic["degree_exponent"]))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    nf, kind = int(traffic["features"]), traffic["feature_kind"]
    if kind == "binary":
        k = int(traffic["feature_nnz_per_row"])
        cols = np.argpartition(rng.random((n, nf), dtype=np.float32), k,
                               axis=1)[:, :k]
        cols.sort(axis=1)
        features = sp.csr_matrix(
            (np.ones(n * k, np.float32), cols.ravel(),
             np.arange(0, n * k + 1, k)), shape=(n, nf))
    elif kind == "uniform":
        features = rng.random((n, nf), dtype=np.float32)
    else:
        raise ValueError(f"unknown feature kind {kind!r}")
    labels = (np.arange(n) % classes)[rng.permutation(n)].astype(np.int64)
    tr, va, te = _split(rng, labels, classes, traffic["split"])
    return Graph(n=n, src=src.astype(np.int64), dst=dst.astype(np.int64),
                 features=features, labels=labels, idx_train=tr, idx_val=va,
                 idx_test=te, classes=classes)


def write_sparsegraph(g: Graph, path: str) -> None:
    """``g`` as a SparseGraph npz with its split stored (the program's
    ``sparsegraph`` format, ``--setting exist``)."""
    adj = g.adjacency()
    fields = dict(adj_data=adj.data, adj_indices=adj.indices,
                  adj_indptr=adj.indptr, adj_shape=np.asarray(adj.shape),
                  labels=g.labels, idx_train=g.idx_train, idx_val=g.idx_val,
                  idx_test=g.idx_test)
    f = g.features
    if sp.issparse(f):
        fields.update(attr_data=f.data, attr_indices=f.indices,
                      attr_indptr=f.indptr, attr_shape=np.asarray(f.shape))
    else:
        fields["attr_matrix"] = f
    np.savez(path, **fields)

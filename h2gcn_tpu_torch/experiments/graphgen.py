"""Synthetic heterophily graph generator (syn-cora / syn-products family).

Modified-preferential-attachment benchmark graphs with controllable
homophily ``h``: each arriving node picks a class, then attaches its ``m``
edges to existing nodes with probability ∝ degree·h (same class) or
degree·(1−h)·w(class distance) (different class), where ``w`` is the
circular-distance heterophily weighting. Reference semantics:
experiments/h2gcn/modules/graphgen.py:69-202.

The reference's per-node Python loop over all existing nodes (its O(n²)
hot spot, graphgen.py:96-112) is replaced by numpy probability vectors over
the nodes placed so far: 10K-node generation in seconds, same distribution.

The port's own copy of ``h2gcn_tpu.experiments.graphgen``: under the same
seed it draws from ``np.random.RandomState`` in the same order, so it gives
the same adjacency lists and colors, bit for bit.
"""

from __future__ import annotations

import gzip
import itertools
import pickle
from pathlib import Path

import numpy as np


class GraphGenerator:
    """Base: holds class count and the planetoid-file save helpers."""

    def __init__(self, num_class):
        self.numClass = num_class

    def format_name(self, graph_name, n_nodes, n_edges, **kwargs):
        return graph_name.format(numNode=n_nodes, numEdge=n_edges,
                                 numClass=self.numClass, **kwargs)

    def save_graph(self, adj_lists, colors, save_path, graph_name, **kwargs):
        """Write the dict-of-lists pickle (`.graph`, planetoid convention)."""
        name = self.format_name(graph_name, len(adj_lists),
                                sum(len(v) for v in adj_lists.values()) // 2,
                                **kwargs)
        path = Path(save_path.format(graphName=name)) / f"{name}.graph"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({k: list(v) for k, v in adj_lists.items()}, f)
        return path

    def save_y(self, adj_lists, colors, save_path, graph_name, **kwargs):
        """Write the one-hot label pickle (`.ally`). Colors are 1-based."""
        name = self.format_name(graph_name, len(adj_lists),
                                sum(len(v) for v in adj_lists.values()) // 2,
                                **kwargs)
        path = Path(save_path.format(graphName=name)) / f"{name}.ally"
        path.parent.mkdir(parents=True, exist_ok=True)
        ally = np.zeros((len(colors), self.numClass))
        for v, color in enumerate(colors):
            if color > 0:
                ally[v][color - 1] = 1
            else:  # unlabeled nodes keep a zero row (reference graphgen.py:54)
                print(f"Node {v} does not have a valid label!")
        with open(path, "wb") as f:
            pickle.dump(ally, f)
        return path

    def save_nx_graph(self, adj_lists, colors, save_path, graph_name, **kwargs):
        """Write a gzip'd pickle of (adj_lists, colors) — the portable
        equivalent of the reference's ``.gpickle.gz`` artifact."""
        name = self.format_name(graph_name, len(adj_lists),
                                sum(len(v) for v in adj_lists.values()) // 2,
                                **kwargs)
        path = Path(save_path.format(graphName=name)) / f"{name}.gpickle.gz"
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wb") as f:
            pickle.dump({"adj": {k: list(v) for k, v in adj_lists.items()},
                         "colors": list(colors)}, f)
        return path


class MixhopGraphGenerator(GraphGenerator):
    """Class-ratio + circular-distance-weighted heterophilous PA generator."""

    def __init__(self, class_ratio, hetero_cls_weight="circularDist",
                 hetero_weights_exponent=1.0, rng=None):
        super().__init__(len(class_ratio))
        self.classRatio = list(class_ratio)
        self.rng = rng if rng is not None else np.random.RandomState()
        self.heteroWeightsDict = {}

        if hetero_cls_weight == "circularDist":
            # count multiplicity of each circular distance
            for i in range(2, self.numClass + 1):
                d = min(i - 1, self.numClass - (i - 1))
                self.heteroWeightsDict[d] = self.heteroWeightsDict.get(d, 0) + 1
            max_dist = max(self.heteroWeightsDict)
            weight_sum = 0.0
            for dist, times in list(self.heteroWeightsDict.items()):
                self.heteroWeightsDict[dist] = hetero_weights_exponent ** (
                    max_dist - dist
                )
                weight_sum += self.heteroWeightsDict[dist] * times
            self.heteroWeightsDict = {
                d: w / weight_sum for d, w in self.heteroWeightsDict.items()
            }
        elif hetero_cls_weight == "uniform":
            for i in range(2, self.numClass + 1):
                d = min(i - 1, self.numClass - (i - 1))
                self.heteroWeightsDict[d] = 1.0 / (self.numClass - 1)
        else:
            raise ValueError(f"unknown heteroClsWeight {hetero_cls_weight}")

    def color_weight(self, col1, col2):
        dist = abs(col1 - col2)
        dist = min(dist, len(self.classRatio) - dist)
        return self.heteroWeightsDict[dist]

    def getH(self, h):
        """Expected class mixing matrix (reference graphgen.py:88-96)."""
        H = np.zeros((self.numClass, self.numClass))
        for i, j in itertools.product(range(self.numClass), repeat=2):
            H[i, j] = h if i == j else self.color_weight(i + 1, j + 1) * (1 - h)
        return H

    # ------------------------------------------------------------- generation
    def _color_sequence(self, n, m):
        """Exact class sizes when Σratio == n, else ∝ ratio sampling."""
        if n > 1 and np.sum(self.classRatio) == n:
            tail = []
            for cls_id, cls_size in enumerate(self.classRatio):
                tail += [cls_id + 1] * int(cls_size - m)
            tail = np.array(tail)
            self.rng.shuffle(tail)
            head = np.array(list(range(1, self.numClass + 1)) * m)
            self.rng.shuffle(head)
            return iter(np.concatenate([head, tail]).tolist())
        return None

    def generate_graph(self, n, m, m0, h):
        if m * self.numClass > m0:
            raise ValueError("requires m * numClass <= m0")
        if m > n:
            raise ValueError("m > n should be satisfied")

        color_iter = self._color_sequence(n, m)

        def next_color():
            if color_iter is not None:
                return next(color_iter)
            ratio = np.asarray(self.classRatio, dtype=float)
            return int(
                self.rng.choice(np.arange(1, self.numClass + 1), 1, False,
                                ratio / ratio.sum())[0]
            )

        colors = np.zeros(n, dtype=np.int64)
        degree = np.zeros(n, dtype=np.int64)
        # per-node same/diff-class weight lookups, vectorized over colors
        weight_table = np.zeros((self.numClass + 1, self.numClass + 1))
        for a in range(1, self.numClass + 1):
            for b in range(1, self.numClass + 1):
                weight_table[a, b] = (
                    h if a == b else (1 - h) * self.color_weight(a, b)
                )

        adj = {v: set() for v in range(n)}

        def add_edge(u, v):
            if v not in adj[u]:
                adj[u].add(v)
                adj[v].add(u)
                degree[u] += 1
                degree[v] += 1

        def sample_neighbors(v, col, count):
            deg = np.maximum(degree[:v], 1).astype(float)
            pr = deg * weight_table[col, colors[:v]]
            norm = pr.sum()
            if norm == 0:
                return None
            return self.rng.choice(v, count, False, pr / norm)

        # seed phase: chain attachment (or weighted for pure homo/heterophily)
        for v in range(m0):
            col = next_color()
            colors[v] = col
            if v > 1:
                if h != 0 and h != 1:
                    add_edge(v, v - 1)
                else:
                    nbr = sample_neighbors(v, col, 1)
                    if nbr is not None:
                        add_edge(v, int(nbr[0]))

        # growth phase: m weighted attachments per arriving node
        for v in range(m0, n):
            col = next_color()
            colors[v] = col
            us = sample_neighbors(v, col, m)
            assert us is not None
            for u in us:
                add_edge(v, int(u))

        assert all(v not in adj[v] for v in range(n)), "self loop generated"
        return adj, colors

    def __call__(self, n, m, m0, h):
        return self.generate_graph(n, m, m0, h)


def adj_lists_to_scipy(adj_lists):
    import scipy.sparse as sp

    n = len(adj_lists)
    rows, cols = [], []
    for u, nbrs in adj_lists.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    A = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)
    )
    A.sum_duplicates()
    A.data[:] = 1.0
    return A

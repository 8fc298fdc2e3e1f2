"""Feature transplant and train/val/test split generation.

Reference semantics (experiments/h2gcn/modules/feature_generation.py):

* ``row_sample`` (:23-33): transplant real feature rows (e.g. Cora) onto
  synthetic nodes — source classes sorted by size are matched to synthetic
  classes sorted by size, then rows are assigned to shuffled synthetic nodes.
* ``select_indices`` (:150-195): split modes — ``<n>c`` per-class count,
  ``<f>p`` per-class ratio, plain count regardless of class, ``""`` = all
  remaining labeled nodes.
* ``generate_split`` (:198-316): sample train/val/test, relabel nodes so the
  training set occupies [0, n_train), and write the full planetoid 8-file
  set + node_mapping (train first, then val, then wild, test appended last —
  the planetoid layout the loaders expect).

The port's own copy of ``h2gcn_tpu.experiments.feature_generation``: the
same draws in the same order, so the same seed writes the same split files,
byte for byte. ``PlanetoidData`` is the port's
(:mod:`h2gcn_tpu_torch.datasets`); ``ogb`` stays an optional, lazy import
and nothing is downloaded.
"""

from __future__ import annotations

import gzip
import json
import pickle
from pathlib import Path

import numpy as np
import scipy.sparse


def get_class_indices(ally, class_id):
    return np.nonzero(ally[:, class_id] == 1)[0]


def row_sample(ally, source_dataset, rng=None):
    """Transplant source-dataset feature rows onto synthetic nodes.

    Classes are matched by descending size (largest source class feeds the
    largest synthetic class); within a class, source features are taken in
    scope order train→val→test and assigned to shuffled synthetic nodes.
    """
    rng = rng if rng is not None else np.random.RandomState()
    class_size = np.sum(ally, axis=0)
    allx = np.zeros((len(ally), source_dataset.feature_dim))
    syn_cls_list = np.argsort(class_size)[::-1]
    src_cls_list = np.argsort(np.asarray(source_dataset.label_count))[::-1]

    feats = source_dataset.features.tocsr()
    for source_cls, syn_cls in zip(src_cls_list, syn_cls_list):
        src_rows = []
        for scope_y in (source_dataset.y_train, source_dataset.y_val,
                        source_dataset.y_test):
            src_rows.extend(np.nonzero(scope_y[:, source_cls] == 1)[0])
        syn_nodes = get_class_indices(ally, syn_cls)
        rng.shuffle(syn_nodes)
        for src_row, syn_node in zip(src_rows, syn_nodes):
            allx[syn_node, :] = np.asarray(feats[src_row].todense()).ravel()
    return allx


def naive_features(ally, dim=None, rng=None):
    """Per-class one-hot block features ("naive" mode,
    reference run_graph_generation.py:254-263)."""
    return ally.copy()


def select_indices(mode, sampled_ind, n_nodes, ally, num_classes, rng):
    """Sample node indices for one split scope; marks ``sampled_ind``."""
    if mode.endswith("c"):
        train_size = int(mode[:-1])
        if n_nodes < train_size * num_classes:
            return None
        out = np.zeros(train_size * num_classes, dtype=np.int64) - 1
        for cls_i in range(num_classes):
            pool = np.nonzero((ally[:, cls_i] == 1) & ~sampled_ind)[0]
            if len(pool) < train_size:
                return None
            chosen = rng.choice(pool, train_size, replace=False)
            out[train_size * cls_i: train_size * (cls_i + 1)] = chosen
            sampled_ind[chosen] = True
        return out
    if mode.endswith("p"):
        ratio = float(mode[:-1])
        out = []
        for cls_i in range(num_classes):
            pool = np.nonzero((ally[:, cls_i] == 1) & ~sampled_ind)[0]
            count = int(np.floor(ratio * (ally[:, cls_i] == 1).sum()))
            chosen = rng.choice(pool, count, replace=False)
            sampled_ind[chosen] = True
            out += list(chosen)
        return np.array(out)
    if mode == "":
        out = np.nonzero(~sampled_ind & (ally.sum(1) > 0))[0]
        sampled_ind[out] = True
        return out
    train_size = int(mode)
    assert n_nodes >= train_size
    pool = np.nonzero(~sampled_ind & (ally.sum(1) > 0))[0]
    out = rng.choice(pool, train_size, replace=False)
    sampled_ind[out] = True
    return out


def relabel_adj_lists(adj_lists, node_mapping):
    return {
        node_mapping[u]: [node_mapping[v] for v in nbrs]
        for u, nbrs in adj_lists.items()
    }


def generate_split(adj_lists, ally, allx, split_config, out_dir,
                   feature_graph_name, rng=None,
                   train_indices=None, test_indices=None,
                   validation_indices=None):
    """Write a planetoid-format split into ``out_dir``.

    ``split_config``: underscore-separated [train, validation, test] modes,
    e.g. ``"0.25p__0.5p"`` (train 25%/class, test 50%/class, validation the
    rest). Returns a result dict (val_size, node_mapping, files) or None if
    the graph has insufficient samples for the requested split.
    """
    rng = rng if rng is not None else np.random.RandomState()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    allx = np.asarray(allx)
    ally = np.asarray(ally)
    num_classes = ally.shape[1]
    n_nodes = ally.shape[0]
    node_mapping = {}
    sampled_ind = np.zeros(n_nodes, dtype=bool)
    words = (split_config.split("_") + ["", "", ""])[:3]

    if train_indices is None:
        train_indices = select_indices(words[0], sampled_ind, n_nodes, ally,
                                       num_classes, rng)
    else:
        assert not np.any(sampled_ind[train_indices])
        sampled_ind[train_indices] = True
    if train_indices is None:
        return None

    assert np.all(train_indices >= 0)
    rng.shuffle(train_indices)
    train_indices = train_indices.astype(int)
    for i, node in enumerate(train_indices):
        node_mapping[node] = i
    x = allx[train_indices, :]
    y = ally[train_indices, :]

    # scope sampling order depends on which modes are given (reference
    # feature_generation.py:244-255)
    if test_indices is not None and validation_indices is not None:
        order = ["test", "validation"]  # stored split: nothing to sample
    elif words[1] != "" and words[2] == "":
        order = ["validation", "test"]
    elif words[1] == "" and words[2] == "":
        raise ValueError(f"Unsupported split config {split_config}")
    else:
        order = ["test", "validation"]

    for scope in order:
        word = words[2] if scope == "test" else words[1]
        given = test_indices if scope == "test" else validation_indices
        if given is None:
            indices = select_indices(word, sampled_ind, n_nodes, ally,
                                     num_classes, rng)
        else:
            assert not np.any(sampled_ind[given])
            sampled_ind[given] = True
            indices = given
        if scope == "test":
            test_indices = indices
        else:
            validation_indices = indices

    if test_indices is None or validation_indices is None:
        return None
    tx = allx[test_indices, :]
    ty = ally[test_indices, :]

    new_allx = np.vstack((x, allx[validation_indices, :]))
    new_ally = np.vstack((y, ally[validation_indices, :]))
    val_size = len(validation_indices)
    for node in validation_indices:
        node_mapping[node] = len(node_mapping)

    if not np.all(sampled_ind):
        wild = np.nonzero(~sampled_ind)[0]
        for node in wild:
            node_mapping[node] = len(node_mapping)
        new_allx = np.vstack((new_allx, allx[wild, :]))
        new_ally = np.vstack((new_ally, ally[wild, :]))

    name = feature_graph_name
    with open(out_dir / f"{name}.test.index", "w") as f:
        for node in test_indices:
            f.write(f"{len(node_mapping)}\n")
            node_mapping[node] = len(node_mapping)

    relabeled = relabel_adj_lists(adj_lists, node_mapping)
    with open(out_dir / f"{name}.graph", "wb") as f:
        pickle.dump({k: list(v) for k, v in sorted(relabeled.items())}, f)
    with gzip.open(out_dir / f"{name}.gpickle.gz", "wb") as f:
        pickle.dump({"adj": {k: list(v) for k, v in relabeled.items()}}, f)

    for fname, obj in ((f"{name}.y", y), (f"{name}.ty", ty),
                       (f"{name}.ally", new_ally)):
        with open(out_dir / fname, "wb") as f:
            pickle.dump(obj, f)
    for fname, obj in ((f"{name}.x", x), (f"{name}.tx", tx),
                       (f"{name}.allx", new_allx)):
        with open(out_dir / fname, "wb") as f:
            pickle.dump(scipy.sparse.csr_matrix(obj), f)

    files = [f"{name}.{suffix}" for suffix in
             ("x", "y", "tx", "ty", "allx", "ally", "graph", "test.index")]
    assert all((out_dir / fn).exists() for fn in files)
    with open(out_dir / "node_mapping.json", "w") as f:
        json.dump({int(k): int(v) for k, v in node_mapping.items()}, f)

    return dict(val_size=val_size, node_mapping=node_mapping,
                files=files, split_name=name)


PLANETOID_SUFFIXES = ("x", "y", "tx", "ty", "allx", "ally", "graph",
                      "test.index")


def match_classes_injective(src_counts, dst_counts):
    """Injective src→dst class matching s.t. per-scope dst counts cover src.

    Replaces the reference's python-constraint solver
    (feature_generation.py:100-108) with a plain backtracking search (no
    external dependency). ``src_counts``: [scopes, n_src]; ``dst_counts``:
    [scopes, n_dst]. Returns {src_class: dst_class} or None.
    """
    n_src = src_counts.shape[1]
    n_dst = dst_counts.shape[1]
    # try scarcer (larger) source classes first for faster pruning
    order = np.argsort(-src_counts.sum(0))
    assignment = {}
    used = set()

    def feasible(src, dst):
        return bool(np.all(dst_counts[:, dst] >= src_counts[:, src]))

    def backtrack(pos):
        if pos == n_src:
            return True
        src = int(order[pos])
        for dst in range(n_dst):
            if dst in used or not feasible(src, dst):
                continue
            assignment[src] = dst
            used.add(dst)
            if backtrack(pos + 1):
                return True
            del assignment[src]
            used.remove(dst)
        return False

    return assignment if backtrack(0) else None


def ogbn_transplant_features(split_dir, split_name, out_dir, out_name,
                             ogbn_name="ogbn-products", ogbn_path=".",
                             rng=None):
    """Transplant ogbn node features onto an existing planetoid split.

    Reference semantics (feature_generation.py:54-139): match synthetic
    classes to ogbn classes so every scope has enough donor nodes, sample
    donor rows per scope without replacement, rewrite x/allx/tx; the
    label/graph files are copied unchanged. Requires the ``ogb`` package
    (gated import; raises a clear error when absent).
    """
    import shutil

    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError as e:  # pragma: no cover - env without ogb
        raise ImportError(
            "ogbn feature transplanting requires the 'ogb' package"
        ) from e

    from ..datasets._dataset import PlanetoidData

    rng = rng if rng is not None else np.random.RandomState()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    import os

    cwd = os.getcwd()
    try:
        os.chdir(ogbn_path)
        dataset = NodePropPredDataset(name=ogbn_name)
    finally:
        os.chdir(cwd)
    split_idx = dataset.get_idx_split()
    graph, label = dataset[0]
    label = np.asarray(label).ravel()
    scopes = [split_idx["train"], split_idx["valid"], split_idx["test"]]

    src = PlanetoidData(split_name, str(split_dir), val_size=None)
    n_classes = src.num_labels
    src_counts = np.zeros((3, n_classes))
    dst_counts = np.zeros((3, dataset.num_classes))
    for i, (mask, idx) in enumerate(zip(
        (src.train_mask, src.val_mask, src.test_mask), scopes
    )):
        src_counts[i] = src.y_all[mask].sum(0)
        dst_counts[i] = (label[idx][:, None]
                         == np.arange(dataset.num_classes)).sum(0)

    solution = match_classes_injective(src_counts, dst_counts)
    if solution is None:
        return None

    feats = np.zeros((src.num_samples, graph["node_feat"].shape[1]))
    for scope_mask, idx in zip(
        (src.train_mask, src.val_mask, src.test_mask), scopes
    ):
        idx_set = set(int(i) for i in idx)
        for src_cls, dst_cls in solution.items():
            sel = scope_mask & (src.labels == src_cls)
            donors = sorted(idx_set.intersection(
                np.where(label == dst_cls)[0].tolist()
            ))
            chosen = rng.choice(donors, int(sel.sum()), replace=False)
            feats[sel, :] = graph["node_feat"][chosen, :]

    for ext in ("y", "ty", "ally", "graph", "test.index"):
        shutil.copy2(Path(split_dir) / f"{split_name}.{ext}",
                     out_dir / f"{out_name}.{ext}")
    x = feats[src.train_mask]
    allx = feats[src.train_mask | src.val_mask]
    tx = feats[src.test_mask]
    for fname, obj in ((f"{out_name}.x", x), (f"{out_name}.allx", allx),
                       (f"{out_name}.tx", tx)):
        with open(out_dir / fname, "wb") as f:
            pickle.dump(scipy.sparse.csr_matrix(obj), f)
    return dict(solution=solution, files=[f"{out_name}.{s}"
                                          for s in PLANETOID_SUFFIXES])

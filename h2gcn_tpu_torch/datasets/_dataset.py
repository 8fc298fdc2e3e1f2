"""Dataset containers: the planetoid pickle and GeomGCN edge-list formats.

The port of ``h2gcn_tpu.datasets._dataset``: loading semantics unchanged
(the citeseer isolated-node patch, non-valid unlabeled nodes masked out of
every split, ``val_size`` validation nodes after the training range;
GeomGCN's edge-file node set, split files and film's feature indices), and
an export (:meth:`GraphData.get_tensors`) that makes torch tensors and
:class:`~h2gcn_tpu_torch.sparse.SparseMatrix` hop matrices on a device.
:class:`GraphData` holds what every container shares, the SparseGraph npz
container (:mod:`.sparsegraph`) included.
"""

from __future__ import annotations

import pickle as pkl
import warnings
from argparse import Namespace
from itertools import chain
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from .. import tracing
from ..sparse import SparseMatrix, transforms
from ..sparse.transforms import NType


def _pkl_load(f):
    return pkl.load(f, encoding="latin1")


def parse_index_file(filename):
    with open(filename) as f:
        return [int(line.strip()) for line in f]


def sample_mask(idx, n):
    mask = np.zeros(n, dtype=bool)
    mask[np.asarray(idx, dtype=np.int64)] = True
    return mask


def graph_dict_to_adj(graph: dict) -> sp.csr_matrix:
    """Binary symmetric adjacency from a dict-of-neighbor-lists.

    Equivalent to ``nx.adjacency_matrix(nx.from_dict_of_lists(g))`` with
    ``nodelist=range(len(g))`` (reference _dataset.py:184-186): every listed
    pair becomes a 1 in both directions, duplicates collapse, self-listed
    nodes keep a diagonal 1.
    """
    n = len(graph)
    src, dst = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            src.append(u)
            dst.append(v)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    both_r = np.concatenate([src, dst])
    both_c = np.concatenate([dst, src])
    adj = sp.csr_matrix(
        (np.ones(both_r.size, dtype=np.float32), (both_r, both_c)), shape=(n, n)
    )
    adj.sum_duplicates()
    adj.data[:] = 1.0
    return adj


class GraphData:
    """What every dataset container shares: attribute access into its
    sparse (``sparse_adj``, ``features``) and dense (``y_all``, the masks
    and per-split labels) data dicts, the preprocessing steps and the
    device export :meth:`get_tensors`. A loader fills the two dicts, then
    calls :meth:`_keep_original`."""

    # Attribute proxying into the data dicts, mirroring the reference's
    # ``__getattribute__`` trick (_dataset.py:307-325).
    def __getattr__(self, name):
        for store in ("_sparse_data", "_dense_data"):
            d = object.__getattribute__(self, store)
            if name in d:
                return d[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        for store in ("_sparse_data", "_dense_data"):
            d = getattr(self, store, None)
            if d is not None and name in d:
                d[name] = value
                return
        object.__setattr__(self, name, value)

    def _keep_original(self):
        self._original_data = (dict(self._sparse_data), dict(self._dense_data))
        self._preprocessed_adj = None
        self._preprocessed_feature = None

    def reload_data(self):
        self._sparse_data, self._dense_data = (
            dict(self._original_data[0]),
            dict(self._original_data[1]),
        )
        self._preprocessed_adj = None
        self._preprocessed_feature = None

    # ------------------------------------------------------------- properties
    @property
    def labels(self):
        idx, labels = np.where(self.y_all)
        labels = labels.astype(np.int32)
        if len(idx) != self.num_samples:  # unlabeled nodes → label -1
            part = labels
            labels = np.zeros(self.num_samples, dtype=np.int32) - 1
            labels[idx] = part
        return labels

    @property
    def num_labels(self):
        return self.y_all.shape[1]

    @property
    def num_samples(self):
        return self.features.shape[0]

    @property
    def feature_dim(self):
        return self.features.shape[1]

    @property
    def label_count(self):
        return self.y_train.sum(0) + self.y_val.sum(0) + self.y_test.sum(0)

    # ---------------------------------------------------------- preprocessing
    def adj_add_eye(self):
        self.sparse_adj = transforms.add_eye(self.sparse_adj)
        self._preprocessed_adj = True

    def adj_remove_eye(self):
        self.sparse_adj = transforms.remove_eye(self.sparse_adj)
        self._preprocessed_adj = True

    def row_normalize_features(self):
        self.features = transforms.row_normalize(self.features)
        self._preprocessed_feature = True

    def set_identity_features(self):
        """Replace node features with the identity (structure-only runs)."""
        self.features = sp.eye(self.num_samples, format="csr", dtype=np.float32)

    def set_label_one_hot_features(self):
        """Replace node features with (train-masked) one-hot labels."""
        feats = np.zeros_like(self.y_all)
        feats[self.train_mask, :] = self.y_all[self.train_mask, :]
        self.features = sp.csr_matrix(feats.astype(np.float32))

    def preprocess_gcn(self, add_eye=True):
        """A+I sym-normalized and row-normalized features (GCN convention)."""
        if self._preprocessed_adj or self._preprocessed_feature:
            self.reload_data()
        if add_eye:
            self.adj_add_eye()
        self.sparse_adj = transforms.normalize(self.sparse_adj,
                                               NType.SYM_NORMALIZED)
        self.row_normalize_features()
        self._preprocessed_adj = "GCN"
        self._preprocessed_feature = "GCN"

    # ---------------------------------------------------------- device export
    # densifying features beyond this element count is refused: an n x n
    # identity-feature matrix at 100K nodes would materialize 40GB
    _DENSE_FEATURE_GUARD = 250_000_000

    def get_tensors(
        self,
        get_adj_hops=None,
        get_adj_norm_hops=None,
        supports=None,
        norm_type: NType = NType.SYM_NORMALIZED,
        backend: str = "auto",
        sparse_features: bool = False,
        precompute_workers: int = 1,
        reorder: str | None = None,
        device="cpu",
    ) -> Namespace:
        """Export tensors on ``device``.

        ``get_adj_norm_hops``: hop groups like ``["1", "2"]`` or
        ``["0,1", "2"]``; each group's exact-hop matrices are summed, then
        normalized (``norm_type``), giving one f32 SparseMatrix per group in
        ``adj_hops``. With ``norm_type=NType.CHEBY`` the groups sum the
        Chebyshev supports T_0..T_kmax (eigenvalue 2) instead.
        ``get_adj_hops`` sums the groups without normalization and exports
        them as one dense ``[n, G, n]`` tensor (refused past the dense
        guard). ``precompute_workers > 1`` runs the exact-hop split over
        that many host workers (:mod:`h2gcn_tpu_torch.parallel.spgemm`; the
        same matrices). ``supports``: scipy matrices exported as they are, one
        SparseMatrix each, as ``adj_hops`` (GCN's sym_norm(A+I), the
        Chebyshev supports, ...). ``sparse_features`` exports X as a
        ``segment`` SparseMatrix (the dense first layer then runs X W
        through ``spmm``), needed past the dense guard. ``reorder`` ("rcm"
        | "cluster") permutes every exported tensor (graph, hops, features,
        labels, masks) by a tile-clustering node order computed on the
        union pattern of what the model aggregates over (the normalized
        hops, else the supports, else the unnormalized hops, else the
        adjacency), exported as ``t.node_perm`` (new position ``i`` holds
        old node ``perm[i]``). ``t.prep_seconds`` holds the host seconds of
        the split, the reorder and the export of the matrices (their
        payloads' table builds): the ``setup.prep.*`` spans.
        """
        device = torch.device(device)

        def hop_groups(spec):
            return [[int(x) for x in elem.split(",")] for elem in spec]

        def padded_split(kmax):
            # nhood_split stops when reachability saturates; the missing
            # exact-hop levels are empty matrices
            splits = transforms.nhood_split(self.sparse_adj, kmax,
                                            n_workers=precompute_workers)
            n = self.num_samples
            while len(splits) < kmax + 1:
                splits.append(sp.csr_matrix((n, n), dtype=splits[0].dtype))
            return splits

        split = tracing.phase("setup.prep.split")
        with split:
            hops_unnorm = None
            if get_adj_hops:
                groups = hop_groups(get_adj_hops)
                n = self.num_samples
                if n * n * len(groups) > self._DENSE_FEATURE_GUARD:
                    raise ValueError(
                        f"get_adj_hops would materialize a dense "
                        f"[{n}, {len(groups)}, {n}] stack "
                        f"({n * n * len(groups):,} elements); use the "
                        "normalized sparse hop pipeline "
                        "(get_adj_norm_hops) at this scale")
                splits = padded_split(max(chain(*groups)))
                hops_unnorm = [sum(splits[i] for i in g) for g in groups]
            normed = None
            if get_adj_norm_hops:
                groups = hop_groups(get_adj_norm_hops)
                kmax = max(chain(*groups))
                if norm_type == NType.CHEBY:
                    splits = transforms.chebyshev_polynomials(
                        self.sparse_adj, kmax, eigenvalue=2)
                    normed = [sum(splits[i] for i in g) for g in groups]
                else:
                    splits = padded_split(kmax)
                    summed = [sum(splits[i] for i in g) for g in groups]
                    normed = [transforms.normalize(m, norm_type)
                              for m in summed]

        perm = None
        reordered = tracing.phase("setup.prep.reorder")
        with reordered:
            if reorder:
                # the order is computed on what the model aggregates over
                parts = (normed if normed is not None
                         else list(supports) if supports is not None
                         else hops_unnorm)
                if parts:
                    pattern = sum(
                        (abs(sp.csr_matrix(p)) for p in parts[1:]),
                        abs(sp.csr_matrix(parts[0])))
                else:
                    pattern = self.sparse_adj
                perm = transforms.cluster_order(pattern, method=reorder)

        def permuted(m):
            return transforms.permute_graph(m, perm) if perm is not None else m

        export = tracing.phase("setup.prep.export")
        with export:
            t = Namespace()
            t.adj = SparseMatrix.from_scipy(
                permuted(self.sparse_adj).astype(np.float32),
                backend=backend, device=device)
            if sparse_features:
                feats = sp.csr_matrix(self.features)
                if perm is not None:
                    feats = feats[perm]
                t.features = SparseMatrix.from_scipy(
                    feats.astype(np.float32), backend="segment",
                    device=device)
            else:
                n_elems = (int(self.features.shape[0])
                           * int(self.features.shape[1]))
                if n_elems > self._DENSE_FEATURE_GUARD:
                    raise ValueError(
                        f"densifying a {self.features.shape} feature matrix "
                        f"({n_elems:,} elements) would exhaust device memory; "
                        "pass sparse_features=True (CLI: --sparse_features) "
                        "to keep X on the sparse SpMM path")
                feats_np = np.asarray(self.features.todense(),
                                      dtype=np.float32)
                if perm is not None:
                    feats_np = feats_np[perm]
                t.features = torch.from_numpy(feats_np).to(device)
            if supports is not None:
                t.adj_hops = [
                    SparseMatrix.from_scipy(permuted(m).astype(np.float32),
                                            backend=backend, device=device)
                    for m in supports
                ]
            if hops_unnorm is not None:
                stack = np.stack([np.asarray(permuted(m).todense())
                                  for m in hops_unnorm], axis=1)
                t.adj_hops = torch.from_numpy(
                    stack.astype(np.float32)).to(device)
            if normed is not None:
                t.adj_hops = [
                    SparseMatrix.from_scipy(permuted(m).astype(np.float32),
                                            backend=backend, device=device)
                    for m in normed
                ]
        t.prep_seconds = {"split": split.seconds,
                          "reorder": reordered.seconds,
                          "export": export.seconds}
        for key, value in self._dense_data.items():
            value = np.asarray(value, dtype=np.float32)
            if perm is not None and value.shape[:1] == (self.num_samples,):
                value = value[perm]
            setattr(t, key, torch.from_numpy(value).to(device))
        labels = np.asarray(self.labels)
        if perm is not None:
            labels = labels[perm]
            t.node_perm = perm
        t.labels = torch.from_numpy(labels).to(device)
        return t


class PlanetoidData(GraphData):
    """Planetoid-format dataset (ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}).

    Reference: h2gcn/datasets/_dataset.py:161-590.
    """

    def __init__(self, dataset_str, dataset_path, val_size=None):
        self._sparse_data = {}
        self._dense_data = {}
        self.dataset_str = dataset_str
        self.dataset_path = dataset_path
        self.load_data(dataset_str, dataset_path, val_size=val_size)
        self._keep_original()

    # ------------------------------------------------------------------ load
    def load_data(self, dataset_str, dataset_path="data", val_size=None):
        names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
        objects = []
        for name in names:
            with open(f"{dataset_path}/{dataset_str}.{name}", "rb") as f:
                objects.append(_pkl_load(f))
        x, y, tx, ty, allx, ally, graph = objects
        test_idx_reorder = parse_index_file(
            f"{dataset_path}/{dataset_str}.test.index"
        )
        test_idx_range = np.sort(test_idx_reorder)

        # citeseer isolated-node patch (reference _dataset.py:226-242)
        test_idx_range_full = range(min(test_idx_reorder), max(test_idx_reorder) + 1)
        if len(test_idx_range_full) != len(test_idx_range):
            print(f"Patch for citeseer dataset applied for {dataset_str}")
            tx_extended = sp.lil_matrix((len(test_idx_range_full), x.shape[1]))
            tx_extended[test_idx_range - min(test_idx_range), :] = tx
            tx = tx_extended
            ty_extended = np.zeros((len(test_idx_range_full), y.shape[1]))
            ty_extended[test_idx_range - min(test_idx_range), :] = ty
            ty = ty_extended
            self._non_valid_samples = set(test_idx_range_full) - set(test_idx_range)
        else:
            self._non_valid_samples = set()

        features = sp.vstack((allx, tx)).tolil()
        features[test_idx_reorder, :] = features[test_idx_range, :]
        adj = graph_dict_to_adj(graph)

        labels = np.vstack((ally, ty))
        labels[test_idx_reorder, :] = labels[test_idx_range, :]

        # Unlabeled nodes are non-valid (citeseer/GeomGCN label bug guard)
        self._non_valid_samples = self._non_valid_samples.union(
            set(np.where(labels.sum(1) == 0)[0].tolist())
        )

        idx_test = test_idx_range.tolist()
        idx_train = range(len(y))
        train_mask = sample_mask(idx_train, labels.shape[0])
        test_mask = sample_mask(idx_test, labels.shape[0])
        val_mask = ~(train_mask | test_mask)
        if val_size is not None:
            if val_mask.sum() > val_size:
                val_mask = sample_mask(range(len(y), len(y) + val_size), labels.shape[0])
            else:
                print(f"Val set size set to {val_mask.sum()} (insufficient samples).")
        wild_mask = ~(train_mask | val_mask | test_mask)

        for n_i in self._non_valid_samples:
            for mask, name in ((train_mask, "training"), (test_mask, "test"),
                               (val_mask, "val")):
                if mask[n_i]:
                    warnings.warn(f"Non valid samples detected in {name} set")
                    mask[n_i] = False
                    break
            wild_mask[n_i] = False

        def masked(labels, mask):
            out = np.zeros(labels.shape)
            out[mask, :] = labels[mask, :]
            return out

        self._sparse_data["sparse_adj"] = adj
        self._sparse_data["features"] = features.tocsr()
        self._dense_data["y_all"] = labels
        self._dense_data["train_mask"] = train_mask
        self._dense_data["val_mask"] = val_mask
        self._dense_data["test_mask"] = test_mask
        self._dense_data["wild_mask"] = wild_mask
        self._dense_data["y_train"] = masked(labels, train_mask)
        self._dense_data["y_val"] = masked(labels, val_mask)
        self._dense_data["y_test"] = masked(labels, test_mask)
        self._dense_data["y_wild"] = masked(labels, wild_mask)

    def set_mixhop_partition(self, val_size=500):
        """Rebuild the split the way the MixHop reference reader does
        (baselines/mixhop/mixhop_dataset.py:184-194): train = ALL nodes
        before the validation window — i.e. the labeled train set PLUS the
        wild nodes — val = the next ``val_size`` ids minus train/test
        overlap, test = the stored test indices.  This is the partition
        every reference MixHop planetoid run trains under (its trainer has
        no notion of the 140-node planetoid train mask)."""
        labels = self.y_all
        n = labels.shape[0]
        test_mask = self.test_mask.copy()
        num_test = int(test_mask.sum())
        num_train = n - val_size - num_test
        train_mask = np.zeros(n, bool)
        train_mask[:num_train] = True
        val_mask = np.zeros(n, bool)
        val_mask[num_train:min(num_train + val_size, n)] = True
        val_mask &= ~train_mask & ~test_mask
        wild_mask = ~(train_mask | val_mask | test_mask)

        def masked(mask):
            out = np.zeros(labels.shape)
            out[mask, :] = labels[mask, :]
            return out

        self._dense_data["train_mask"] = train_mask
        self._dense_data["val_mask"] = val_mask
        self._dense_data["wild_mask"] = wild_mask
        self._dense_data["y_train"] = masked(train_mask)
        self._dense_data["y_val"] = masked(val_mask)
        self._dense_data["y_wild"] = masked(wild_mask)

    def sort_label_by_size(self, descending=True):
        """Class ids ordered by size (reference _dataset.py:432-436)."""
        order = np.argsort(np.asarray(self.label_count))
        return order[::-1] if descending else order

    def feature_sample_eligible(self, label_count):
        """Can this dataset donate features for the given class sizes?
        (reference _dataset.py:457-461)"""
        own = np.sort(np.asarray(self.label_count))[::-1]
        want = np.sort(np.asarray(label_count))[::-1]
        if len(want) > len(own):
            return False
        return bool(np.all(want <= own[: len(want)]))

    def get_sample_mask(self, label=slice(None), *scopes):
        """Mask of nodes with the given label(s) in the given scopes
        (reference _dataset.py:380-398)."""
        if len(scopes) == 0:
            scopes = ("train", "val", "test")
        if not isinstance(label, slice):
            label = np.array(label).reshape(-1)
        mask = np.zeros(self.num_samples, dtype=bool)
        for scope in scopes:
            y_scope = self._dense_data[f"y_{scope}"]
            mask |= np.any(y_scope[:, label] == 1, axis=1)
        return mask

    def split_training_set(self, splits=2):
        """Round-robin per-class split of the training set
        (reference _dataset.py:463-474)."""
        self.train_mask_splits = np.zeros(
            (splits,) + self.train_mask.shape, dtype=self.train_mask.dtype
        )
        self.y_train_splits = np.zeros(
            (splits,) + self.y_train.shape, dtype=self.y_train.dtype
        )
        for label in range(self.y_train.shape[1]):
            available = np.where(self.y_train[:, label])[0]
            for i, index in enumerate(available):
                self.train_mask_splits[i % splits, index] = (
                    self.train_mask[index]
                )
                self.y_train_splits[i % splits, index, :] = (
                    self.y_train[index, :]
                )


class GeomGCNData(PlanetoidData):
    """GeomGCN edge-list datasets (texas, wisconsin, cornell, chameleon,
    squirrel, film, ...): ``out1_node_feature_label.txt`` (node id, comma
    separated binary features, label) and ``out1_graph_edges.txt`` (one
    edge a line).

    Only nodes that appear in the edge file are kept, renumbered in
    ascending id order; the edges are symmetrized unless
    ``directed_graph``. ``splits_file_path`` names a GeomGCN split npz
    (``train_mask``, ``val_mask``, ``test_mask``); without it every mask is
    empty. film's features are the indices of its set bits among 932,
    read as uint16 (uint8 would wrap past 255).
    """

    def __init__(self, dataset_str, dataset_path, splits_file_path=None,
                 directed_graph=False,
                 adj_filename="out1_graph_edges.txt",
                 feature_filename="out1_node_feature_label.txt"):
        self._sparse_data = {}
        self._dense_data = {}
        self.dataset_str = dataset_str
        self.dataset_path = dataset_path
        self.load_data(dataset_str, dataset_path, splits_file_path,
                       directed_graph, adj_filename, feature_filename)
        self._keep_original()

    def load_data(self, dataset_str, dataset_path, splits_file_path=None,
                  directed_graph=False,
                  adj_filename="out1_graph_edges.txt",
                  feature_filename="out1_node_feature_label.txt"):
        feat_path = Path(dataset_path) / feature_filename
        adj_path = Path(dataset_path) / adj_filename

        features_dict, labels_dict = {}, {}
        with open(feat_path) as f:
            f.readline()
            for line in f:
                nid, feat, label = line.rstrip().split("\t")
                nid = int(nid)
                assert nid not in features_dict
                if dataset_str == "film":
                    blank = np.zeros(932, dtype=np.uint8)
                    blank[np.array(feat.split(","), dtype=np.uint16)] = 1
                    features_dict[nid] = blank
                else:
                    features_dict[nid] = np.array(feat.split(","),
                                                  dtype=np.uint8)
                labels_dict[nid] = int(label)

        src, dst = [], []
        nodes = set()
        with open(adj_path) as f:
            f.readline()
            for line in f:
                u, v = (int(t) for t in line.rstrip().split("\t"))
                src.append(u)
                dst.append(v)
                nodes.add(u)
                nodes.add(v)
        node_list = sorted(nodes)
        remap = {nid: i for i, nid in enumerate(node_list)}
        n = len(node_list)
        r = np.array([remap[u] for u in src])
        c = np.array([remap[v] for v in dst])
        if not directed_graph:
            r, c = np.concatenate([r, c]), np.concatenate([c, r])
        adj = sp.csr_matrix(
            (np.ones(r.size, dtype=np.float32), (r, c)), shape=(n, n))
        adj.sum_duplicates()
        adj.data[:] = 1.0

        features = np.stack([features_dict[nid] for nid in node_list]).astype(
            np.float32)
        labels = np.array([labels_dict[nid] for nid in node_list],
                          dtype=np.int32)
        y_all = np.zeros((n, labels.max() + 1))
        y_all[np.arange(n), labels] = 1

        self._sparse_data["sparse_adj"] = adj
        self._sparse_data["features"] = sp.csr_matrix(features)
        self._dense_data["y_all"] = y_all

        if splits_file_path:
            self.load_splits(splits_file_path)
        else:
            for key in ("train_mask", "val_mask", "test_mask", "wild_mask"):
                self._dense_data[key] = np.zeros(n, dtype=bool)
            self._derive_split_labels()
            self.splitted = False

    def load_splits(self, splits_file_path):
        """Load a GeomGCN ``*_split_0.6_0.2_<i>.npz`` split file."""
        with np.load(splits_file_path) as s:
            self._dense_data["train_mask"] = s["train_mask"].astype(bool)
            self._dense_data["val_mask"] = s["val_mask"].astype(bool)
            self._dense_data["test_mask"] = s["test_mask"].astype(bool)
        self._dense_data["wild_mask"] = ~(
            self.train_mask | self.val_mask | self.test_mask)
        self._derive_split_labels()
        self.splitted = True

    def _derive_split_labels(self):
        labels = self._dense_data["y_all"]
        for scope in ("train", "val", "test", "wild"):
            mask = self._dense_data[f"{scope}_mask"]
            y = np.zeros(labels.shape)
            y[mask, :] = labels[mask, :]
            self._dense_data[f"y_{scope}"] = y

    @property
    def label_count(self):
        if not getattr(self, "splitted", False):
            return self.y_all.sum(0)
        return super().label_count

"""SparseGraph container, npz IO, preprocessing and the dataset plugin.

The port of ``h2gcn_tpu.datasets.sparsegraph``: a CSR-adjacency graph
container with attributes, labels and names; the ``.npz`` storage format
(adj/attr/labels plus name arrays); the standard preprocessing
(undirected, unweighted and self-loop free standardization, the largest
connected component, subgraphs, label binarization, underrepresented-class
removal); and :class:`SparseGraphData`, the ``sparsegraph`` dataset
format, with stored (``exist``) or seeded random splits.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import tracing
from ..sparse import transforms
from ._dataset import GraphData


class SparseGraph:
    """Attributed labeled graph stored in scipy CSR format."""

    def __init__(self, adj_matrix, attr_matrix=None, labels=None,
                 node_names=None, attr_names=None, class_names=None,
                 metadata=None):
        if sp.isspmatrix(adj_matrix):
            adj_matrix = adj_matrix.tocsr().astype(np.float32)
        else:
            raise ValueError("adjacency must be a scipy sparse matrix")
        if adj_matrix.shape[0] != adj_matrix.shape[1]:
            raise ValueError("adjacency must be square")
        if attr_matrix is not None:
            if sp.isspmatrix(attr_matrix):
                attr_matrix = attr_matrix.tocsr().astype(np.float32)
            elif isinstance(attr_matrix, np.ndarray):
                attr_matrix = attr_matrix.astype(np.float32)
            else:
                raise ValueError("attr_matrix must be sparse or ndarray")
            if attr_matrix.shape[0] != adj_matrix.shape[0]:
                raise ValueError("attribute/adjacency dimension mismatch")
        if labels is not None:
            labels = np.asarray(labels)
            if labels.shape[0] != adj_matrix.shape[0]:
                raise ValueError("label/adjacency dimension mismatch")
        self.adj_matrix = adj_matrix
        self.attr_matrix = attr_matrix
        self.labels = labels
        self.node_names = node_names
        self.attr_names = attr_names
        self.class_names = class_names
        self.metadata = metadata

    # ------------------------------------------------------------- properties
    def num_nodes(self) -> int:
        return self.adj_matrix.shape[0]

    def num_edges(self) -> int:
        if self.is_directed():
            return int(self.adj_matrix.nnz)
        return int(self.adj_matrix.nnz) // 2

    @property
    def num_labels(self) -> int:
        return int(self.labels.max()) + 1

    @property
    def label_count(self):
        return np.unique(self.labels[self.labels >= 0], return_counts=True)[1]

    @property
    def num_unknown_labels(self) -> int:
        return int((np.asarray(self.labels) < 0).sum())

    def get_neighbors(self, idx):
        return self.adj_matrix[idx].indices

    # ---------------------------------------------------------- standardizing
    def is_directed(self) -> bool:
        return (self.adj_matrix != self.adj_matrix.T).sum() != 0

    def to_undirected(self) -> "SparseGraph":
        if self.is_weighted():
            raise ValueError(
                "Convert to unweighted graph first (weighted edges would be "
                "summed when symmetrizing)."
            )
        self.adj_matrix = self.adj_matrix + self.adj_matrix.T
        self.adj_matrix[self.adj_matrix != 0] = 1
        return self

    def is_weighted(self) -> bool:
        return np.any(np.unique(self.adj_matrix[self.adj_matrix != 0].A1) != 1)

    def to_unweighted(self) -> "SparseGraph":
        self.adj_matrix.data = np.ones_like(self.adj_matrix.data)
        return self

    def standardize(self) -> "SparseGraph":
        """Unweighted + undirected + no self loops + largest connected comp."""
        g = self.to_unweighted().to_undirected()
        g.adj_matrix = eliminate_self_loops_adj(g.adj_matrix)
        return largest_connected_components(g, 1)

    def unpack(self):
        return self.adj_matrix, self.attr_matrix, self.labels


def eliminate_self_loops_adj(A: sp.csr_matrix) -> sp.csr_matrix:
    if A.diagonal().sum() > 0:
        A = A.tolil()
        A.setdiag(0)
        A = A.tocsr()
        A.eliminate_zeros()
    return A


# ------------------------------------------------------------------------- IO
def load_npz_to_sparse_graph(file_name) -> SparseGraph:
    with np.load(str(file_name), allow_pickle=True) as loader:
        loader = dict(loader)
        adj_matrix = sp.csr_matrix(
            (loader["adj_data"], loader["adj_indices"], loader["adj_indptr"]),
            shape=loader["adj_shape"],
        )
        if "attr_data" in loader:
            attr_matrix = sp.csr_matrix(
                (loader["attr_data"], loader["attr_indices"],
                 loader["attr_indptr"]),
                shape=loader["attr_shape"],
            )
        elif "attr_matrix" in loader:
            attr_matrix = loader["attr_matrix"]
        else:
            attr_matrix = None
        if "labels_data" in loader:
            labels = sp.csr_matrix(
                (loader["labels_data"], loader["labels_indices"],
                 loader["labels_indptr"]),
                shape=loader["labels_shape"],
            )
            labels = np.asarray(labels.argmax(1)).ravel()
        elif "labels" in loader:
            labels = loader["labels"]
        else:
            labels = None
        return SparseGraph(
            adj_matrix, attr_matrix, labels,
            node_names=loader.get("node_names"),
            attr_names=loader.get("attr_names"),
            class_names=loader.get("class_names"),
            metadata=loader.get("metadata"),
        )


def save_sparse_graph_to_npz(filepath, g: SparseGraph):
    fields = {
        "adj_data": g.adj_matrix.data,
        "adj_indices": g.adj_matrix.indices,
        "adj_indptr": g.adj_matrix.indptr,
        "adj_shape": g.adj_matrix.shape,
    }
    if sp.isspmatrix(g.attr_matrix):
        fields.update(
            attr_data=g.attr_matrix.data,
            attr_indices=g.attr_matrix.indices,
            attr_indptr=g.attr_matrix.indptr,
            attr_shape=g.attr_matrix.shape,
        )
    elif g.attr_matrix is not None:
        fields["attr_matrix"] = g.attr_matrix
    if g.labels is not None:
        fields["labels"] = g.labels
    for name in ("node_names", "attr_names", "class_names", "metadata"):
        if getattr(g, name) is not None:
            fields[name] = getattr(g, name)
    if not str(filepath).endswith(".npz"):
        filepath = str(filepath) + ".npz"
    np.savez(filepath, **fields)


def load_dataset(data_path) -> SparseGraph:
    data_path = str(data_path)
    if not data_path.endswith(".npz"):
        data_path += ".npz"
    return load_npz_to_sparse_graph(data_path)


# ---------------------------------------------------------------- preprocess
def to_binary_bag_of_words(features):
    features_copy = features.tocsr()
    features_copy.data[:] = 1.0
    return features_copy


def normalize_adj(A):
    """Sym-normalize without self loops: D^-1/2 (A) D^-1/2 after removing
    the diagonal (reference sparsegraph/preprocess.py:27-34)."""
    A = eliminate_self_loops_adj(sp.csr_matrix(A))
    d = np.ravel(A.sum(1))
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(d, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0
    D = sp.diags(d_inv_sqrt)
    return D @ A @ D


def renormalize_adj(A):
    """GCN renormalization: sym-normalize A + I."""
    return normalize_adj(A + sp.eye(A.shape[0]))


def row_normalize(matrix):
    return transforms.row_normalize(matrix)


def add_self_loops(A, value=1.0):
    A = A.tolil(copy=True)
    A.setdiag(value)
    return A.tocsr()


def largest_connected_components(g: SparseGraph, n_components=1) -> SparseGraph:
    _, labels = sp.csgraph.connected_components(g.adj_matrix, directed=False)
    counts = np.bincount(labels)
    keep_comp = np.argsort(counts)[::-1][:n_components]
    keep = np.isin(labels, keep_comp)
    return create_subgraph(g, nodes_to_keep=np.nonzero(keep)[0])


def create_subgraph(g: SparseGraph, nodes_to_remove=None, nodes_to_keep=None):
    if (nodes_to_remove is None) == (nodes_to_keep is None):
        raise ValueError("provide exactly one of nodes_to_remove/nodes_to_keep")
    if nodes_to_keep is None:
        nodes_to_keep = sorted(
            set(range(g.num_nodes())) - set(np.asarray(nodes_to_remove))
        )
    nodes_to_keep = np.asarray(sorted(nodes_to_keep))
    adj = g.adj_matrix[nodes_to_keep][:, nodes_to_keep]
    attr = None if g.attr_matrix is None else g.attr_matrix[nodes_to_keep]
    labels = None if g.labels is None else np.asarray(g.labels)[nodes_to_keep]
    node_names = (None if g.node_names is None
                  else np.asarray(g.node_names)[nodes_to_keep])
    return SparseGraph(adj, attr, labels, node_names, g.attr_names,
                       g.class_names, g.metadata)


def binarize_labels(labels, sparse_output=False, return_classes=False):
    classes = np.unique(labels)
    n = len(labels)
    label_matrix = np.zeros((n, len(classes)), dtype=np.int64)
    class_to_idx = {c: i for i, c in enumerate(classes)}
    for i, lab in enumerate(labels):
        label_matrix[i, class_to_idx[lab]] = 1
    if sparse_output:
        label_matrix = sp.csr_matrix(label_matrix)
    if return_classes:
        return label_matrix, classes
    return label_matrix


def remove_underrepresented_classes(g: SparseGraph, train_examples_per_class,
                                    val_examples_per_class) -> SparseGraph:
    min_examples = train_examples_per_class + val_examples_per_class
    examples_counter = np.bincount(np.asarray(g.labels))
    keep_classes = set(np.nonzero(examples_counter > min_examples)[0])
    keep = [i for i, lab in enumerate(np.asarray(g.labels))
            if lab in keep_classes]
    return create_subgraph(g, nodes_to_keep=keep)


# ---------------------------------------------------------------- CLI plugin
class SparseGraphData(GraphData):
    """Dataset container over an .npz SparseGraph.

    The reference's DeepRobust-compatible ``CustomDataset``
    (npz-datasets/dataset.py:5-65): symmetrize and binarize the adjacency,
    optionally keep the largest connected component, zero the diagonal,
    and take either the stored splits (``setting="exist"``: idx_train,
    idx_val and idx_test arrays inside the npz) or random per-ratio splits
    drawn from ``seed``. Accessors, preprocessing and the device export
    are :class:`GraphData`'s, as for the planetoid format.
    """

    def __init__(self, npz_path, setting="gcn", require_lcc=False,
                 val_size=None, seed=15, train_ratio=0.1, val_ratio=0.1):
        self._sparse_data = {}
        self._dense_data = {}
        self.dataset_str = str(npz_path)
        g = load_npz_to_sparse_graph(npz_path)

        adj = g.adj_matrix
        adj = adj + adj.T
        adj = adj.tolil()
        adj[adj > 1] = 1
        features = g.attr_matrix
        labels = np.asarray(g.labels)
        if require_lcc:
            _, comp = sp.csgraph.connected_components(adj.tocsr(),
                                                      directed=False)
            keep = np.nonzero(comp == np.bincount(comp).argmax())[0]
            adj = adj[keep][:, keep]
            features = features[keep]
            labels = labels[keep]
        adj.setdiag(0)
        adj = adj.astype("float32").tocsr()
        adj.eliminate_zeros()
        assert np.abs(adj - adj.T).sum() == 0, "graph is not symmetric"

        n = adj.shape[0]
        num_labels = int(labels.max()) + 1
        labeled = labels >= 0  # -1 marks unknown labels; keep their rows zero
        y_all = np.zeros((n, num_labels))
        y_all[np.nonzero(labeled)[0], labels[labeled]] = 1

        if setting == "exist":
            with np.load(str(npz_path), allow_pickle=True) as loader:
                idx_train = loader["idx_train"]
                idx_val = loader["idx_val"]
                idx_test = loader["idx_test"]
        else:
            rng = np.random.RandomState(seed)
            pool = np.nonzero(labeled)[0]
            perm = pool[rng.permutation(len(pool))]
            n_train = int(np.round(train_ratio * len(pool)))
            n_val = (val_size if val_size is not None
                     else int(np.round(val_ratio * len(pool))))
            idx_train = perm[:n_train]
            idx_val = perm[n_train:n_train + n_val]
            idx_test = perm[n_train + n_val:]

        masks = {}
        for scope, idx in (("train", idx_train), ("val", idx_val),
                           ("test", idx_test)):
            mask = np.zeros(n, dtype=bool)
            mask[np.asarray(idx, dtype=np.int64)] = True
            mask &= labeled  # unlabeled nodes are non-valid in every split
            masks[scope] = mask
        wild = ~(masks["train"] | masks["val"] | masks["test"]) & labeled

        if sp.isspmatrix(features):
            features = features.tocsr()
        else:
            features = sp.csr_matrix(features)

        self._sparse_data["sparse_adj"] = adj
        self._sparse_data["features"] = features
        self._dense_data["y_all"] = y_all
        for scope in ("train", "val", "test"):
            self._dense_data[f"{scope}_mask"] = masks[scope]
            y = np.zeros_like(y_all)
            y[masks[scope]] = y_all[masks[scope]]
            self._dense_data[f"y_{scope}"] = y
        self._dense_data["wild_mask"] = wild
        y_wild = np.zeros_like(y_all)
        y_wild[wild] = y_all[wild]
        self._dense_data["y_wild"] = y_wild
        self._keep_original()


def add_subparser_args(parser):
    group = parser.add_argument_group(
        "SparseGraph npz Data Arguments (datasets/sparsegraph.py)"
    )
    group.add_argument("--dataset", type=str, required=True,
                       help="npz file name (without extension)")
    group.add_argument("--dataset_path", type=str, dest="_dataset_path",
                       required=True)
    group.add_argument("--setting", choices=["gcn", "exist", "nettack"],
                       default="gcn")
    group.add_argument("--require_lcc", action="store_true")
    group.add_argument("--val_size", type=int, default=-1)
    group.add_argument("--split_seed", type=int, default=15)
    parser.function_hooks["argparse"].appendleft(argparse_callback)


def argparse_callback(args):
    import os.path as osp

    path = osp.join(args._dataset_path, args.dataset + ".npz")
    with tracing.phase("setup.load"):
        dataset = SparseGraphData(
            path, setting=args.setting,
            require_lcc=(args.require_lcc or args.setting == "nettack"),
            val_size=(args.val_size if args.val_size >= 0 else None),
            seed=args.split_seed,
        )
    args.objects["dataset"] = dataset
    print(f"===> Dataset loaded: {args.dataset} (SparseGraph npz)")

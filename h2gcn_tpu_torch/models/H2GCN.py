"""H2GCN model plugin (Zhu et al., NeurIPS 2020, Beyond Homophily).

The default network setup ``M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO`` is H2GCN-2:
ego and neighbor embeddings kept apart (aggregation runs on the self-loop
free adjacency, the ego embedding re-enters through the tag concats),
exact-1-hop and exact-2-hop adjacencies each symmetrically normalized, and
a jumping-knowledge concat of every intermediate representation. Flags and
defaults are those of the JAX package's plugin.
"""

import torch

from .. import nn
from ..nn.dsl import Layer
from ..sparse.transforms import NType
from . import _runtime


def add_subparser_args(parser):
    group = parser.add_argument_group("H2GCN Model Arguments (H2GCN.py)")
    group.add_argument("--network_setup", type=str,
                       default="M64-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO",
                       help="Default to H2GCN-2 (%(default)s)")
    group.add_argument("--dropout", type=float, default=0.5,
                       help="Default dropout rate")
    group.add_argument("--hidden", type=int, default=64)
    group.add_argument("--adj_nhood", default=["1", "2"], type=str, nargs="+")
    group.add_argument("--optimizer", type=str, default="adam",
                       help="(default: %(default)s)")
    group.add_argument("--lr", type=float, default=0.01,
                       help="(default: %(default)s)")
    group.add_argument("--l2_regularize_weight", type=float, default=5e-4,
                       help="(default: %(default)s)")
    group.add_argument("--early_stopping", type=int, default=0,
                       help="Epoch window for sliding-mean early stopping "
                            "(0 disables) (default: %(default)s)")
    group.add_argument("--best_val_criteria", choices=["val_acc", "val_loss"],
                       default="val_acc")
    group.add_argument("--save_activations", action="store_true")
    group.add_argument("--save_predictions", nargs="+", type=bool, default=True)
    group.add_argument("--no_feature_normalize", action="store_true")
    group.add_argument("--adj_norm_type",
                       choices=[t.name for t in NType],
                       default="SYM_NORMALIZED")
    group.add_argument("--sparse_backend",
                       choices=["auto", "dense", "bsr", "cootile", "gscatter",
                                "segment"],
                       default="auto",
                       help="SpMM execution backend for the hop matrices")
    group.add_argument("--sparse_features", action="store_true",
                       help="Keep X sparse on the device (X W through the "
                            "SpMM core); needed for large feature matrices")
    group.add_argument("--precompute_workers", type=int, default=1,
                       help="Row-shard the exact-hop precompute over N "
                            "host workers")
    group.add_argument("--reorder", choices=["none", "rcm", "cluster"],
                       default="none",
                       help="Tile-clustering node permutation applied to "
                            "every exported tensor (the COO-tile backend "
                            "then visits fewer tiles on large graphs)")
    parser.function_hooks["argparse"].append(argparse_callback)


def argparse_callback(args):
    dataset = args.objects["dataset"]
    layer_setups = nn.parse_network_setup(
        args.network_setup, dataset.num_labels,
        _dense_units=args.hidden, _dropout_rate=args.dropout,
    )
    layer_types = set(x[0] for x in layer_setups)
    preprocessing_data(args, normalized_hops=Layer.GCN in layer_types)
    model = nn.NetworkModel(
        layer_setups, l2_regularize_weight=args.l2_regularize_weight
    )
    _runtime.initialize_model(
        args, model, args.optimizer, args.lr, args.early_stopping,
        seed=getattr(args, "random_seed", None),
    )


def preprocessing_data(args, normalized_hops=True):
    """Row-normalize features (unless disabled), drop self loops, and build
    the exact-hop adjacency tensors on the run's device: normalized sparse
    hop matrices, or for a setup without graph layers the unnormalized
    dense hop stack."""
    dataset = args.objects["dataset"]
    if not args.no_feature_normalize:
        dataset.row_normalize_features()
    dataset.adj_remove_eye()
    hops = (dict(get_adj_norm_hops=args.adj_nhood) if normalized_hops
            else dict(get_adj_hops=args.adj_nhood))
    tensors = dataset.get_tensors(
        **hops,
        norm_type=NType[args.adj_norm_type], backend=args.sparse_backend,
        sparse_features=args.sparse_features,
        precompute_workers=args.precompute_workers,
        reorder=None if args.reorder == "none" else args.reorder,
        device=torch.device(args._device),
    )
    args.objects["tensors"] = vars(tensors)

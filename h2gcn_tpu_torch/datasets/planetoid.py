"""Planetoid-format dataset plugin (ind.<name>.{x,y,tx,ty,allx,ally,graph,
test.index})."""

from ._dataset import PlanetoidData


def add_subparser_args(parser):
    group = parser.add_argument_group(
        "Planetoid Format Data Arguments (datasets/planetoid.py)"
    )
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--dataset_path", type=str, dest="_dataset_path",
                       required=True)
    group.add_argument("--val_size", type=int, default=500)
    group.add_argument(
        "--feature_configs",
        choices=["no_test", "identity", "labels"],
        nargs="*",
        default=[],
    )
    parser.function_hooks["argparse"].appendleft(argparse_callback)


def argparse_callback(args):
    if args.val_size < 0:
        args.val_size = None
    dataset = PlanetoidData(args.dataset, args._dataset_path, val_size=args.val_size)
    for config in args.feature_configs:
        if config == "no_test":
            lil = dataset.features.tolil()
            lil[dataset.test_mask, :] = 0
            dataset.features = lil.tocsr()
        elif config == "identity":
            dataset.set_identity_features()
        elif config == "labels":
            dataset.set_label_one_hot_features()
    args.objects["dataset"] = dataset
    print(f"===> Dataset loaded: {args.dataset}")

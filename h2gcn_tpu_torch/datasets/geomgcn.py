"""GeomGCN edge-list dataset plugin (texas, wisconsin, cornell, chameleon,
squirrel, film, ...): :class:`GeomGCNData`, with an optional stored split
file."""

from ._dataset import GeomGCNData


def add_subparser_args(parser):
    group = parser.add_argument_group(
        "GeomGCN Format Data Arguments (datasets/geomgcn.py)"
    )
    group.add_argument("--dataset", type=str, required=True)
    group.add_argument("--dataset_path", type=str, dest="_dataset_path",
                       required=True)
    group.add_argument("--splits_file_path", type=str, default=None,
                       dest="_splits_file_path")
    group.add_argument("--directed_graph", action="store_true")
    parser.function_hooks["argparse"].appendleft(argparse_callback)


def argparse_callback(args):
    dataset = GeomGCNData(
        args.dataset,
        args._dataset_path,
        splits_file_path=args._splits_file_path,
        directed_graph=args.directed_graph,
    )
    args.objects["dataset"] = dataset
    print(f"===> Dataset loaded: {args.dataset} (GeomGCN format)")

"""Argument/hook engine: the runtime's plugin wiring.

There is no Trainer class: plugins add argparse groups and an ordered deque
of post-parse callbacks, which fill ``args.objects`` (tensors, step
functions, epoch callbacks).

``--use_signac`` records the run in the built-in
:mod:`h2gcn_tpu_torch.modules.runstore` (signac itself is not a
dependency): the job's statepoint is every argument whose name has no
leading underscore.
"""

import argparse
from collections import deque


def create_parser():
    parser = argparse.ArgumentParser(add_help=False)
    parser.function_hooks = dict()
    parser.function_hooks["argparse"] = deque()
    return parser


def parse_args(parser: argparse.ArgumentParser, argv=None):
    parser.add_argument("--use_signac", default=False, action="store_true",
                        help="Record this run in the built-in run store")
    parser.add_argument("--signac_root", default=None, dest="_signac_root",
                        help="Root path of the run-store project")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--help", "-h", action="help")
    parser.add_argument("--exp_tags", default=[], nargs="+", dest="_exp_tags")

    args = parser.parse_args(argv)
    args.objects = dict(function_hooks=parser.function_hooks)

    if args.use_signac:
        from ..parallel.mesh import owns_files
        from . import runstore

        # in a distributed run, rank 0 alone writes the store; the other
        # ranks hold the same job without touching the disk
        writer = owns_files()
        project = runstore.get_project(root=args._signac_root, create=writer)
        args.objects["signac_project"] = project
        statepoint = {
            name: value
            for name, value in vars(args).items()
            if (not name.startswith("_")) and (name != "objects")
        }
        job = project.open_job(statepoint)
        args.objects["signac_job"] = job
        if writer:
            job.init()
            job.doc["exp_tags"] = args._exp_tags

    args.objects["pretrain_callbacks"] = deque()
    args.objects["pre_epoch_callbacks"] = deque()
    args.objects["post_epoch_callbacks"] = deque()
    args.objects["post_train_callbacks"] = deque()
    while len(parser.function_hooks["argparse"]) > 0:
        hook = parser.function_hooks["argparse"].popleft()
        hook(args)

    return args

"""Argument/hook engine: the runtime's plugin wiring.

There is no Trainer class: plugins add argparse groups and an ordered deque
of post-parse callbacks, which fill ``args.objects`` (tensors, step
functions, epoch callbacks).
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
                        help="Record this run in the run store (not ported)")
    parser.add_argument("--signac_root", default=None, dest="_signac_root")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--help", "-h", action="help")
    parser.add_argument("--exp_tags", default=[], nargs="+", dest="_exp_tags")

    args = parser.parse_args(argv)
    if args.use_signac:
        raise NotImplementedError(
            "--use_signac: the run store is not ported to h2gcn_tpu_torch "
            "yet (ROADMAP A5)")
    args.objects = dict(function_hooks=parser.function_hooks)
    args.objects["pretrain_callbacks"] = deque()
    args.objects["pre_epoch_callbacks"] = deque()
    args.objects["post_epoch_callbacks"] = deque()
    args.objects["post_train_callbacks"] = deque()
    while len(parser.function_hooks["argparse"]) > 0:
        hook = parser.function_hooks["argparse"].popleft()
        hook(args)

    return args

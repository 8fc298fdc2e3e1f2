"""Dataset-format plugin registry.

Dataset-format modules are discovered by filename, the positional
``datafmt`` argument selects one, and its ``add_subparser_args`` adds flags
plus a post-parse callback that loads the dataset into
``args.objects["dataset"]`` (the JAX package's contract, unchanged).
"""

import argparse
import contextlib
import importlib
import os
import pkgutil


def available_formats():
    return [
        modname
        for _, modname, _ in pkgutil.iter_modules(path=__path__)
        if not modname.startswith("_")
    ]


def add_subparsers(parser: argparse.ArgumentParser, argv=None):
    parser.add_argument(
        "datafmt", choices=available_formats(), help="Dataset format"
    )
    try:
        with open(os.devnull, "w") as devnull, contextlib.redirect_stderr(devnull):
            known_args, _ = parser.parse_known_args(argv)
        fmt = known_args.datafmt
    except SystemExit:
        return
    module = importlib.import_module("." + fmt, package=__name__)
    if hasattr(module, "add_subparser_args"):
        module.add_subparser_args(parser)
        print(f"Using dataset format: {fmt}")

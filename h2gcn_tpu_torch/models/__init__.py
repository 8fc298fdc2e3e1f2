"""Model plugin registry.

Model modules are discovered by filename, the positional ``model`` argument
selects one, and its ``add_subparser_args`` adds flags plus a post-parse
callback that builds the model and registers train/test step functions into
``args.objects`` (the JAX package's contract, unchanged).
"""

import argparse
import contextlib
import importlib
import os
import pkgutil


def available_models():
    return [
        modname
        for _, modname, _ in pkgutil.iter_modules(path=__path__)
        if not modname.startswith("_")
    ]


def add_subparsers(parser: argparse.ArgumentParser, argv=None):
    parser.add_argument(
        "model", choices=available_models(),
        help="Network model selected for experiment",
    )
    try:
        with open(os.devnull, "w") as devnull, contextlib.redirect_stderr(devnull):
            known_args, _ = parser.parse_known_args(argv)
        model_name = known_args.model
    except SystemExit:
        return
    module = importlib.import_module("." + model_name, package=__name__)
    if hasattr(module, "add_subparser_args"):
        module.add_subparser_args(parser)
        print(f"Using model: {module.__name__}")

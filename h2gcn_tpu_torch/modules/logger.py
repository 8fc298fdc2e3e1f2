"""Checkpoint path management and epoch-stat printing.

Metric-templated checkpoint names, relocation of a pre-existing checkpoint
directory, save/remove/restore of the training state, and the fixed-format
epoch line (the JAX package's semantics).
"""

from __future__ import annotations

import shutil
import tempfile
from datetime import datetime
from pathlib import Path

from .. import tracing
from ..parallel.mesh import owns_files
from . import checkpoint as ckpt_io


def add_subparser_args(parser):
    group = parser.add_argument_group("Logging arguments (modules/logger.py)")
    group.add_argument(
        "--checkpoint_dir",
        type=str,
        default="results/checkpoints/{model}_{dataset}_{runname}",
    )
    group.add_argument(
        "--checkpoint_name",
        type=str,
        default="{model}_{dataset}_{{epoch:04d}}_ta{{test_accuracy:.4f}}_va{{val_acc:.4f}}",
    )
    group.add_argument("--message", "-m", default=None,
                       help="Comments appended after runname")
    group.add_argument(
        "--run_id",
        default=datetime.now().strftime("%Y%m%d_%H%M%S"),
        help="(default: %(default)s)",
    )
    group.add_argument(
        "--ckpt_every_epoch", action="store_true", dest="_ckpt_every_epoch",
        help="Write every epoch's checkpoint to disk; by default the best "
        "state is kept in device memory and written once at the end.",
    )
    parser.function_hooks["argparse"].append(init_checkpoint_path)


def init_checkpoint_path(args):
    if not args.use_signac:
        if args.message is not None:
            args.run_id = args.run_id + "-" + args.message
        args.objects["checkpoint_dir"] = args.checkpoint_dir.format(
            runname=args.run_id, model=args.model, dataset=args.dataset
        )
    else:
        # a recorded run keeps its checkpoints in its job's workspace
        args.objects["checkpoint_dir"] = str(
            Path(args.objects["signac_job"].workspace()) / "checkpoints"
        )
    args.objects["checkpoint_name"] = args.checkpoint_name.format(
        model=args.model, dataset=args.dataset
    )
    if not owns_files():
        return  # rank 0 of a distributed run owns the directory
    target = Path(args.objects["checkpoint_dir"])
    if target.exists():
        mv_target = tempfile.mkdtemp(prefix="checkpoints_", dir=target.parent)
        target.replace(mv_target)
    target.mkdir(parents=True)
    print("===> Checkpoints will be saved to {}".format(args.objects["checkpoint_dir"]))


def save_ckpt(state, args, epoch, epoch_stats) -> str:
    """Save the training state under a metric-templated name."""
    stats = {k: (tracing.readback(v) if hasattr(v, "item") else v)
             for k, v in epoch_stats.items()
             if not isinstance(v, dict) and k != "epoch"}
    ckpt_name = args.objects["checkpoint_name"].format(epoch=epoch, **stats)
    ckpt_path = Path(args.objects["checkpoint_dir"]) / ckpt_name / ckpt_io.CKPT_FILE
    ckpt_io.save_state(ckpt_path, state)
    return ckpt_name


def remove_ckpt(args, ckpt_name):
    if ckpt_name is None:
        return
    path = Path(args.objects["checkpoint_dir"]) / ckpt_name
    if path.exists():
        shutil.rmtree(str(path))


def restore_ckpt(args, ckpt_name):
    return ckpt_io.load_state(Path(args.objects["checkpoint_dir"]) / ckpt_name)


class EpochStatsPrinter:
    """Fixed-format epoch line; prints nothing when not ``enabled`` (a
    rank other than 0 of a distributed run)."""

    def __init__(self, format_str=None, enabled=True):
        self.enabled = enabled
        self.format_str = format_str or "    ".join(
            [
                "Epoch: {epoch:04}",
                "Train Loss: {train_loss:9.6f}",
                "Train Acc: {train_acc:7.2%}",
                "Val Loss: {val_loss:9.6f}",
                "Val Acc: {val_acc:7.2%}",
                "Test Acc: {test_accuracy:7.2%}",
            ]
        )

    @staticmethod
    def _floats(stats: dict) -> dict:
        return {
            k: (tracing.readback(v) if hasattr(v, "item") else v)
            for k, v in stats.items()
        }

    def __call__(self, epoch, epoch_stats: dict):
        if not self.enabled:
            return
        print(self.format_str.format(epoch=epoch, **self._floats(epoch_stats)))

    def from_dict(self, epoch_stats: dict):
        if not self.enabled:
            return
        print(self.format_str.format(**self._floats(epoch_stats)))
        if "monitor" in epoch_stats:
            print(epoch_stats["monitor"])

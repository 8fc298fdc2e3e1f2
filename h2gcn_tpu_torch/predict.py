"""Inference entry point: load a checkpoint, write predictions.

``python -m h2gcn_tpu_torch.predict <MODEL> <DATAFMT> --dataset ...
--restore_checkpoint <ckpt.pt or its directory> --output preds.npz``

Builds the whole plugin stack (model, dataset, preprocessing hooks) as the
training CLI does, restores the checkpoint, runs the registered
``predict_step`` once and writes the logits, the class probabilities
(softmax in float32), the predicted labels and the split masks. It runs on
``--device cuda`` (the default) and raises without a GPU; pass ``--device
cpu`` to run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import datasets, models
from .modules import arguments, checkpoint, logger, monitor
from .run_experiments import resolve_device


def main(argv=None):
    parser = arguments.create_parser()
    parser.add_argument("--random_seed", type=int, default=123)
    parser.add_argument("--epochs", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        dest="_device",
                        help="Device of the run (default: %(default)s)")
    parser.add_argument("--restore_checkpoint", type=str, default=None,
                        dest="_restore_checkpoint",
                        help="ckpt.pt (or its directory) with the trained "
                             "state; omit to predict with the fresh "
                             "initialization (a smoke test)")
    parser.add_argument("--output", type=str, default="predictions.npz",
                        dest="_output")

    known_args, _ = parser.parse_known_args(argv)
    resolve_device(known_args._device)

    models.add_subparsers(parser, argv)
    datasets.add_subparsers(parser, argv)
    logger.add_subparser_args(parser)
    monitor.add_subparser_args(parser)
    args = arguments.parse_args(parser, argv)

    if args._restore_checkpoint:
        from .models._runtime import restore

        state = checkpoint.load_state(args._restore_checkpoint)
        restore(args.objects["model"], args.objects["optimizer"], state)
        print(f"===> Restored state from {args._restore_checkpoint}")

    tensors = args.objects["tensors"]
    logits = args.objects["predict_step"](**tensors).float()
    probs = torch.softmax(logits, dim=-1)
    out = dict(
        logits=logits.cpu().numpy(),
        predicted_prob=probs.cpu().numpy(),
        predicted_label=logits.argmax(1).cpu().numpy(),
    )
    for key in ("train_mask", "val_mask", "test_mask"):
        if key in tensors:
            out[key] = tensors[key].cpu().numpy()
    np.savez(args._output, **out)
    print(f"===> Wrote predictions for {logits.shape[0]} nodes to "
          f"{args._output}")
    return args


if __name__ == "__main__":
    main()

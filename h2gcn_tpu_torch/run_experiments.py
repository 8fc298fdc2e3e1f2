"""Training entry point.

``python -m h2gcn_tpu_torch.run_experiments <MODEL> <DATAFMT> --dataset ...``

The epoch protocol of the JAX package's CLI: pretrain callbacks, then per
epoch train_step and test_step merging their stat dicts, pre/post-epoch
callbacks, and post-train callbacks, all driven through ``args.objects``
closures so model and dataset plugins stay decoupled from the loop.

It runs on ``--device cuda`` (the default) and raises when no GPU is
present; the CPU runs only when asked for with ``--device cpu``.

``--mesh_shards N`` (N > 1) runs the distributed runtime on N ranks, one
a device (NCCL on the card, gloo on the CPU; ``--halo_mode`` picks the
boundary exchange). Where the JAX package drives its N devices from one
process, this command spawns the N ranks itself and returns rank 0's best
epoch; under ``torchrun --nproc_per_node N`` each process is already a
rank and runs as one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from . import datasets, models, tracing
from .modules import arguments, checkpoint, logger, monitor
from .parallel.mesh import owns_files


def resolve_device(name: str) -> torch.device:
    """The run's device. ``cuda`` raises without a GPU (nothing falls back
    to the CPU) and turns TF32 off: matmuls run in full f32, the
    ``highest`` precision of the JAX package."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA GPU is available; pass "
                           "--device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steady_epoch_ms(times):
    """(mean, median) milliseconds per epoch over every epoch after the
    first, which also builds and warms up; the mean is the epoch-time
    metric (a stall in any epoch moves it)."""
    steady = times[1:] or times
    return 1e3 * statistics.fmean(steady), 1e3 * statistics.median(steady)


def kernel_launches() -> dict:
    """Launches of each CUDA kernel wrapper in this process so far (each
    wrapper counts where it launches its kernel, as the counter
    ``launches.<wrapper>``), leaving out the kernels that launched none:
    ``{}`` for a run on the CPU."""
    return {k.split(".", 1)[1]: v
            for k, v in tracing.counters("launches.").items() if v}


def main(argv=None):
    t_main = time.perf_counter()
    spans = tracing.new_store()
    parser = arguments.create_parser()
    parser.add_argument("--random_seed", type=int, default=123)
    parser.add_argument("--interactive", "-i", action="store_true",
                        dest="_interactive",
                        help="Drop into IPython after training")
    parser.add_argument("--restore_checkpoint", type=str, default=None,
                        dest="_restore_checkpoint",
                        help="Path to a ckpt.pt (or its directory) to "
                             "resume training from")
    parser.add_argument("--epochs", type=int, default=2000,
                        help="(default: %(default)s)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        dest="_device",
                        help="Device of the run (default: %(default)s)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        dest="_profile_dir",
                        help="Write a torch.profiler trace of epochs 3-5 here")
    parser.add_argument("--timing", action="store_true", dest="_timing",
                        help="Record per-epoch wall time and edges/s, and "
                             "print the kernels' launches (with "
                             "--use_signac also into the job's doc)")
    parser.add_argument("--epochs_per_block", type=int, default=1,
                        dest="_epochs_per_block",
                        help="Run K train and eval epochs per block with "
                             "the best state selected on the device: one "
                             "stats readback per K epochs")
    parser.add_argument("--mesh_shards", type=int, default=0,
                        dest="_mesh_shards",
                        help="Shard the graph over N devices, one rank a "
                             "device (NCCL on cuda, gloo on cpu): the "
                             "command spawns the N ranks, unless it runs "
                             "as a rank of a world of N already (torchrun) "
                             "(default: one device)")
    parser.add_argument("--halo_mode", default="ring",
                        choices=["ring", "allgather", "halo",
                                 "halo-cootile"],
                        dest="_halo_mode",
                        help="Boundary exchange with --mesh_shards: ring "
                             "(node chunks rotate round the ranks), "
                             "allgather, halo (one all_to_all of the "
                             "boundary rows, overlapped with the interior "
                             "reduce) or halo-cootile (halo with the local "
                             "reduces on the COO-tile kernel) "
                             "(default: %(default)s)")

    known_args, _ = parser.parse_known_args(argv)
    device = resolve_device(known_args._device)
    n_ranks = known_args._mesh_shards
    if n_ranks > 1 and not _joined_world(known_args._device):
        # the JAX package drives N devices from one process; torch runs a
        # process a device, so this command starts the N ranks
        from .parallel.mesh import spawn

        argv = list(sys.argv[1:] if argv is None else argv)
        stats = spawn(_rank_main, n_ranks, device.type, argv)
        return argparse.Namespace(objects={"best_val_stats": stats})

    models.add_subparsers(parser, argv)
    datasets.add_subparsers(parser, argv)
    logger.add_subparser_args(parser)
    monitor.add_subparser_args(parser)

    args = arguments.parse_args(parser, argv)
    args.objects["spans"] = spans

    if getattr(args, "_restore_checkpoint", None) and "model" in args.objects:
        from .models._runtime import restore

        state = checkpoint.load_state(args._restore_checkpoint)
        restore(args.objects["model"], args.objects["optimizer"], state)
        print(f"===> Resumed training state from {args._restore_checkpoint}")

    for func in args.objects["pretrain_callbacks"]:
        func(**args.objects["tensors"])

    timing = getattr(args, "_timing", False)
    nnz_per_epoch = 0
    if timing:
        hops = args.objects["tensors"].get("adj_hops")
        if hops is None:
            hops = []
        if isinstance(hops, (list, tuple)):  # a dense hop stack has no nnz
            nnz_per_epoch = sum(getattr(h, "nnz", 0) for h in hops)
            if not hops:
                # models without hop matrices (GAT, GraphSAGE's ELL graph)
                # aggregate over the support
                nnz_per_epoch = getattr(args.objects["tensors"].get("adj"),
                                        "nnz", 0)
        args.objects["epoch_times"] = []
    profile_dir = getattr(args, "_profile_dir", None)
    profiler = None

    # --timing traces the whole run, --profile_dir its profiled epochs
    was_on = tracing.enable(timing or tracing.enabled())
    try:
        block_k = getattr(args, "_epochs_per_block", 1) or 1
        ran_blocked = False
        if block_k > 1 and "train_block" in args.objects:
            if args.objects["pre_epoch_callbacks"]:
                print("===> --epochs_per_block ignored: model registered "
                      "per-epoch callbacks (e.g. minibatch re-masking)")
            else:
                if profile_dir:
                    print("===> --profile_dir is a per-epoch-loop feature; "
                          "ignored with --epochs_per_block")
                    profile_dir = None
                _blocked_loop(args, block_k)
                ran_blocked = True

        if not ran_blocked:
            args.current_epoch = 0
        while not ran_blocked and args.current_epoch < args.epochs:
            args.current_epoch += 1
            if profile_dir and args.current_epoch == 3:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
                profiled_was_on = tracing.enable()
            t_epoch = time.perf_counter()
            for func in args.objects["pre_epoch_callbacks"]:
                func(args.current_epoch, args)
            args.objects["epoch_stats"] = dict()
            args.objects["epoch_stats"].update(
                args.objects["train_step"](**args.objects["tensors"])
            )
            args.objects["epoch_stats"].update(
                args.objects["test_step"](**args.objects["tensors"])
            )
            if timing:
                # the steps return before the device finishes: wait for it
                _sync(device)
                dt = time.perf_counter() - t_epoch
                args.objects["epoch_times"].append(dt)
                args.objects["epoch_stats"]["epoch_time_s"] = dt
                if nnz_per_epoch:
                    # 2 forward passes (train+eval) + backward = 3 aggregations
                    args.objects["epoch_stats"]["agg_edges_per_s"] = (
                        3 * nnz_per_epoch / dt
                    )
            if profiler is not None and args.current_epoch >= 5:
                _stop_profiler(profiler, profile_dir, device)
                tracing.enable(profiled_was_on)
                profiler = profile_dir = None
            for func in args.objects["post_epoch_callbacks"]:
                func(args.current_epoch, args)
            while (args.current_epoch >= args.epochs
                   and len(args.objects["post_train_callbacks"]) > 0):
                func = args.objects["post_train_callbacks"].popleft()
                func(args)

        if profiler is not None:
            # the run ended before epoch 5 (short run or early stop)
            _stop_profiler(profiler, profile_dir, device)
    finally:
        tracing.enable(was_on)

    if timing:
        # main_s: the run from main's entry on (a child's seconds before
        # it are the interpreter's start and the imports); prep_s: the
        # host set-up of the tensors (split, reorder, payload tables);
        # spans: each span's count, host seconds, seconds outside its
        # child spans and launches over the run (spans_dropped: past the
        # store's cap); counters: this process's
        prep = args.objects["tensors"].get("prep_seconds") or {}
        record = {"launches": kernel_launches(),
                  "main_s": time.perf_counter() - t_main,
                  "prep_s": sum(prep.values()),
                  "spans": spans.summary(),
                  "spans_dropped": spans.dropped,
                  "counters": tracing.counters()}
        if args.objects.get("epoch_times"):
            times = args.objects["epoch_times"]
            mean_ms, median_ms = steady_epoch_ms(times)
            print(f"===> Timing: {len(times)} epochs, "
                  f"{mean_ms:.2f} ms/epoch after the first "
                  f"(median {median_ms:.2f}; first epoch "
                  f"{1e3 * times[0]:.1f} ms)")
            record.update(epochs=len(times), epoch_ms=mean_ms,
                          epoch_ms_median=median_ms,
                          first_epoch_ms=1e3 * times[0])
        print(f"===> Kernel launches: {json.dumps(record['launches'])}")
        print(f"===> Spans: {json.dumps(record['spans'])}")
        print(f"===> Counters: {json.dumps(record['counters'])}")
        if args.use_signac and owns_files():
            args.objects["signac_job"].doc["timing"] = record
    if getattr(args, "_interactive", False):
        import IPython

        IPython.embed()
    return args


def _joined_world(device_type: str) -> bool:
    """True when this process is a rank of a world: one it joined, or one
    that torchrun's environment (``WORLD_SIZE``) describes, joined here."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if os.environ.get("WORLD_SIZE") is None:
        return False
    from .parallel import multihost

    multihost.initialize(device_type=device_type)
    return dist.is_initialized()


def _rank_main(argv):
    """One spawned rank of ``--mesh_shards N``: the run, and its best
    epoch's stats (floats and names) for the launching command."""
    best = main(argv).objects["best_val_stats"] or {}
    return {k: (float(v) if hasattr(v, "item") else v)
            for k, v in best.items()
            if isinstance(v, (int, float, str)) or hasattr(v, "item")}


def _blocked_loop(args, k):
    """Training in blocks of ``k`` epochs (``--epochs_per_block``).

    Each block is one call of ``train_block``, which returns the block's
    stacked per-epoch stats in one readback; the epoch protocol is replayed
    on the host from them: the stat lines, best-val bookkeeping (the best
    state itself is selected on the device) and sliding-mean early
    stopping. The last block shrinks so that no block runs past
    ``--epochs``. With ``--timing``, a block's seconds (it ends in its
    readback) over its epochs give the epoch time of each block after the
    first, which also builds and warms up.
    """
    from .models._runtime import update_best_val_stats

    stats_printer = args.objects["statsPrinter"]
    early_stopping = args.objects["early_stopping"]
    es_metric = args.objects.get("es_metric", "val_loss")
    timing = bool(getattr(args, "_timing", False))
    block_times = []  # (epochs, seconds) of each block

    t0 = time.perf_counter()
    args.current_epoch = 0
    stopped = False
    while args.current_epoch < args.epochs and not stopped:
        k_eff = min(k, args.epochs - args.current_epoch)
        t_block = time.perf_counter()
        stack = args.objects["train_block"](
            k_eff, args.current_epoch + 1, **args.objects["tensors"])
        block_times.append((k_eff, time.perf_counter() - t_block))
        for i in range(k_eff):
            args.current_epoch += 1
            epoch_stats = {key: v[i] for key, v in stack.items()}
            epoch_stats["monitor"] = dict()
            args.objects["epoch_stats"] = epoch_stats
            stats_printer(args.current_epoch, epoch_stats)
            update_best_val_stats(args, epoch_stats, args.current_epoch)
            if early_stopping(epoch_stats[es_metric]):
                print("Early stopping...")
                args.epochs = args.current_epoch
                stopped = True
                break

    wall = time.perf_counter() - t0
    print(f"===> Blocked training: {args.current_epoch} epochs in "
          f"{wall:.2f}s ({1e3 * wall / max(args.current_epoch, 1):.2f} "
          "ms/epoch with the first block)")
    args.objects["block_times"] = block_times
    if timing and len(block_times) > 1:
        # an epoch's seconds in each block of the first block's size; the
        # first is dropped by steady_epoch_ms
        k0 = block_times[0][0]
        per_epoch = [t / ke for ke, t in block_times if ke == k0]
        if len(per_epoch) > 1:
            mean_ms, median_ms = steady_epoch_ms(per_epoch)
            print(f"===> Timing (blocked): {mean_ms:.2f} ms/epoch over "
                  f"{len(per_epoch) - 1} block(s) of {k0} after the first "
                  f"(median {median_ms:.2f}; first block "
                  f"{block_times[0][1]:.2f} s)")
    while len(args.objects["post_train_callbacks"]) > 0:
        func = args.objects["post_train_callbacks"].popleft()
        func(args)
    return args


def _stop_profiler(profiler, profile_dir, device):
    from pathlib import Path

    _sync(device)
    profiler.stop()
    path = Path(profile_dir)
    path.mkdir(parents=True, exist_ok=True)
    profiler.export_chrome_trace(str(path / "trace.json"))
    print(f"===> Profiler trace written to {path}")


if __name__ == "__main__":
    main()

"""Experiments CLI: ``python -m h2gcn_tpu_torch.experiments <command> ...``

Commands:
  init       — create graph/feature/split jobs from a generation config
  generate   — run the generation pipeline (graphs, stats, features, splits)
  sweep      — run model sweeps from an experiment config (resumable)
  summarize  — emit a results CSV for a sweep config
  stats      — emit a graph-statistics CSV
  status     — show per-graph pipeline/sweep completion labels
  clean      — remove failed/stale runs (md5 mismatch)
  clear      — remove ALL experiment runs under each graph

The port's copy of ``python -m h2gcn_tpu.experiments``: the same commands
and flags. Sweeps train through ``h2gcn_tpu_torch.run_experiments``, on
the card unless ``--extra_args '--device cpu'`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..modules.runstore import get_project
from . import generation, summarize, workflow


def main(argv=None):
    parser = argparse.ArgumentParser(prog="h2gcn_tpu_torch.experiments")
    sub = parser.add_subparsers(dest="command", required=True)

    p_init = sub.add_parser("init")
    p_init.add_argument("root")
    p_init.add_argument("--config", "-c", required=True)

    p_gen = sub.add_parser("generate")
    p_gen.add_argument("root")
    p_gen.add_argument("--config", "-c", default=None)
    p_gen.add_argument("--cora_path", default=None,
                       help="planetoid dir for cora_row feature sampling")

    p_sweep = sub.add_parser("sweep")
    p_sweep.add_argument("root")
    p_sweep.add_argument("--config", "-c", required=True)
    p_sweep.add_argument("--parallel", "-p", type=int, default=1)
    p_sweep.add_argument("--epochs", type=int, default=None)
    p_sweep.add_argument("--tuning", action="store_true")
    p_sweep.add_argument("--extra_args", default=None,
                         help="extra args appended to every child run "
                              "(single quoted string, e.g. '--device cpu')")

    p_sum = sub.add_parser("summarize")
    p_sum.add_argument("root")
    p_sum.add_argument("--config", "-f", required=True)
    p_sum.add_argument("--output", "-o", default="results.csv")
    p_sum.add_argument("--path_only", action="store_true")

    p_stats = sub.add_parser("stats")
    p_stats.add_argument("root")
    p_stats.add_argument("--output", "-o", default="graph_stats.csv")

    p_status = sub.add_parser("status")
    p_status.add_argument("root")
    p_status.add_argument("--config", "-c", default=None)

    for name in ("clean", "clear"):
        p_c = sub.add_parser(name)
        p_c.add_argument("root")
        p_c.add_argument("--config", "-c", default=None)

    args = parser.parse_args(argv)

    if args.command == "init":
        with open(args.config) as f:
            config = json.load(f)
        project = generation.init_project(args.root, config)
        print(f"Initialized {len(project)} graph jobs under {args.root}")
    elif args.command == "generate":
        config = None
        if args.config:
            with open(args.config) as f:
                config = json.load(f)
        cora = None
        if args.cora_path:
            from ..datasets._dataset import PlanetoidData

            # val_size=None → every labeled node lands in a scope, making all
            # 2708 feature rows available for transplanting
            cora = PlanetoidData("ind.cora", args.cora_path, val_size=None)
        generation.run_pipeline(args.root, config, cora_source=cora)
    elif args.command == "sweep":
        workflow.run_sweep(
            args.root, args.config, parallel=args.parallel,
            epochs=args.epochs, tuning=args.tuning,
            extra_args=args.extra_args.split() if args.extra_args else None,
        )
    elif args.command == "summarize":
        summarize.summarize_experiments(
            args.root, args.config, output_csv=args.output,
            path_only=args.path_only,
        )
    elif args.command == "stats":
        summarize.summarize_graph_stats(args.root, output_csv=args.output)
    elif args.command == "status":
        project = get_project(args.root)
        config = workflow.load_config(args.config) if args.config else None
        for job in project:
            labels = []
            if generation.graph_generated(job):
                labels.append("graph_generated")
            if generation.statistics_calculated(job):
                labels.append("statistics_calculated")
            if generation.split_generated(job):
                labels.append("split_generated")
            if config and workflow.model_experiments_finished(job, config):
                labels.append("model_experiments_finished")
            print(f"{job.id[:10]} {job.sp.get('graphName')}: "
                  f"{', '.join(labels) or '(pending)'}")
    elif args.command == "clean":
        config = workflow.load_config(args.config) if args.config else {}
        for job in get_project(args.root):
            removed = workflow.clean_workspace(job, config)
            if removed:
                print(f"{job.id[:10]}: removed {len(removed)} runs")
    elif args.command == "clear":
        for job in get_project(args.root):
            removed = workflow.clear_workspace(job)
            if removed:
                print(f"{job.id[:10]}: cleared {removed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Result summarization: sweep results and graph statistics → CSV.

Reference: experiments/h2gcn/run_experiments_summarization.py:32-262 and
graph_statistics_summarization.py:15-79. Walks the
graph → feature → split → model hierarchy, matches runs by their
content-hashed ``run_id``, reads each run's ``results.json``, and emits one
CSV row per (graph, split, model-args) combination. The port's copy of
``h2gcn_tpu.experiments.summarize``: the same columns and rows for the same
store.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

from ..modules.runstore import get_project
from . import workflow

RESULT_FIELDS = ["train_loss", "train_acc", "val_loss", "val_acc",
                 "test_loss", "test_accuracy", "epoch"]


def default_result_parser(run_job) -> dict:
    path = Path(run_job.fn("results.json"))
    if not path.exists():
        return {}
    with open(path) as f:
        results = json.load(f)
    return {k: results.get(k) for k in RESULT_FIELDS}


def summarize_experiments(root, config, output_csv=None,
                          result_parser=default_result_parser,
                          path_only=False):
    """Collect one row per succeeded run. Returns the row list."""
    if isinstance(config, (str, Path)):
        config = workflow.load_config(config)
    project = get_project(str(root))
    rows = []
    for graph_job in project:
        if not workflow._graph_matches(graph_job,
                                       config.get("graph_filter_dict")):
            continue
        for split_job, fg_name, files, args, run_id in workflow.iter_runs(
            graph_job, config
        ):
            ws = Path(split_job.workspace()) / workflow.WORKSPACE_ROOT
            if not ws.exists():
                continue
            model_project = get_project(str(ws))
            for run_job in model_project.find_jobs({"run_id": run_id}):
                if not run_job.doc.get("succeeded", False):
                    continue
                if path_only:
                    rows.append({"path": run_job.workspace()})
                    continue
                row = {
                    "Graph Name": graph_job.sp.get("graphName"),
                    "numClass": graph_job.sp.get("numClass"),
                    "h": graph_job.sp.get("h"),
                    "homoEdgeRatio": graph_job.doc.get("homoEdgeRatio"),
                    "Feature": fg_name,
                    "Model Args": args,
                    "Graph ID": graph_job.id,
                    "Split ID": split_job.id,
                    "run_id": run_id,
                }
                row.update(result_parser(run_job))
                rows.append(row)
    if output_csv and rows:
        _write_csv(output_csv, rows)
    return rows


def summarize_graph_stats(root, output_csv=None, stats=None):
    """One row of statistics per generated graph."""
    project = get_project(str(root))
    stats = stats or ["numNodes", "numEdges", "avg_degree", "max_degree",
                      "min_degree", "homoEdgeRatio", "GeomGCNBeta",
                      "avgClusteringCoeff", "avgSPLength", "numComponents",
                      "numTotalTriangles", "numSelfLoops", "numNoLabel"]
    rows = []
    for graph_job in project:
        row = {
            "Graph Name": graph_job.sp.get("graphName"),
            "Graph ID": graph_job.id,
            "numClass": graph_job.sp.get("numClass"),
            "h": graph_job.sp.get("h"),
        }
        for key in stats:
            row[key] = graph_job.doc.get(key)
        rows.append(row)
    if output_csv and rows:
        _write_csv(output_csv, rows)
    return rows


def _write_csv(path, rows):
    keys = list(rows[0].keys())
    for row in rows[1:]:
        for k in row:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)
    print(f"Wrote {len(rows)} rows to {path}")

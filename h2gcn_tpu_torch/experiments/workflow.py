"""Experiment sweep workflow: run model configs over the dataset hierarchy.

The run-store counterpart of the reference's signac-flow sweep template
(experiments/h2gcn/experiments_workflow.py:1-457): for every
graph → feature → split leaf, each entry of the config's ``model_args`` runs
as a child training process whose identity is
``run_id = "<args>@<md5-of-the-8-split-files>"`` — so results are resumable
(succeeded runs are skipped) and stale results are detectable when split
files change. Child stdout streams to both the console and the split's
``terminal_output.log``.

The port's copy of ``h2gcn_tpu.experiments.workflow``. The child is
``python -u -m h2gcn_tpu_torch.run_experiments``, which runs on the card
unless ``--device cpu`` reaches it through ``extra_args``; a child that
fails raises :class:`subprocess.CalledProcessError`. The run ids are the
JAX package's for the same split files. A succeeded run's doc also holds
``wall_s``, the child's seconds from its start to its exit (its imports and
kernel load included). ``run_sweep(parallel>1)`` spreads the graph jobs
over a pool of *spawned* processes: a caller may hold a CUDA context, which
a forked worker must not inherit; the workers only start children, and a
failure in any of them raises in the caller.

Config JSON (same schema as the reference ``configs/*/*.json``)::

    {"model_args": ["H2GCN --network_setup ...", ...],
     "exp_regex": "...", "arg_regex": "...",
     "graph_filter_dict": {...}, "split_filter": {...}}
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from ..modules.runstore import Job, get_project
from . import generation

WORKSPACE_ROOT = "experiments/hgcn_experiments"
EXP_CODE = "hgcn_exp"


def calculate_md5(path, chunk=65536) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def split_files_md5(split_job: Job, files) -> str:
    return "_".join(calculate_md5(split_job.fn(f)) for f in files)


def load_config(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _graph_matches(job: Job, graph_filter: dict) -> bool:
    return all(job.statepoint.get(k) == v for k, v in (graph_filter or {}).items())


def dataset_args(model_args_str, split_job: Job, feature_graph_name, run_id):
    """Build the child CLI argv (reference run_hgcn_experiments.py:13-29)."""
    parts = model_args_str.split()
    model, rest = parts[0], parts[1:]
    datafmt = split_job.sp.get("format", "planetoid")
    argv = [model, datafmt] + rest + [
        "--dataset_path", split_job.workspace(),
        "--dataset", feature_graph_name,
        f"--run_id={run_id}",
        "--use_signac",
        "--signac_root", str(Path(split_job.workspace()) / WORKSPACE_ROOT),
    ]
    if split_job.doc.get("val_size") is not None:
        argv += ["--val_size", str(split_job.doc["val_size"])]
    return argv


def iter_runs(graph_job: Job, config: dict, tuning=False):
    """Yield (split_job, feature_graph_name, files, model_args, run_id)."""
    exp_regex = config.get("exp_regex", "")
    arg_regex = config.get("arg_regex")
    split_filter = config.get("split_filter")
    split_doc_filter = config.get("split_doc_filter")
    for feature_job, split_job, fg_name, files in generation.feature_split_iter(
        graph_job
    ):
        if split_job.doc.get("disabled", False):
            continue
        if exp_regex and re.search(exp_regex, fg_name) is None:
            continue
        if split_filter and any(
            split_job.sp.get(k) != v for k, v in split_filter.items()
        ):
            continue
        if split_doc_filter and any(
            split_job.doc.get(k) != v for k, v in split_doc_filter.items()
        ):
            continue
        if tuning and split_job.sp.get("split_index", None) not in (None, 0):
            continue
        if not all(split_job.isfile(f) for f in files):
            continue
        md5 = split_files_md5(split_job, files)
        for args in config.get("model_args", []):
            if arg_regex and re.search(arg_regex, args) is None:
                continue
            run_id = f"{args}@{md5}"
            if tuning:
                run_id += "[tuning]"
            yield split_job, fg_name, files, args, run_id


def run_model(graph_job: Job, config: dict, *, epochs=None, tuning=False,
              extra_args=None, python=None, dry_run=False, env=None):
    """Run every pending (split × model_args) combination under a graph job."""
    python = python or sys.executable
    results = []
    for split_job, fg_name, files, args, run_id in iter_runs(
        graph_job, config, tuning
    ):
        ws = Path(split_job.workspace()) / WORKSPACE_ROOT
        ws.mkdir(parents=True, exist_ok=True)
        model_project = get_project(str(ws))
        if any(
            j.doc.get("succeeded", False)
            for j in model_project.find_jobs({"run_id": run_id})
        ):
            print(f"[run_model] already run; skip {fg_name} / {args}")
            continue
        argv = [python, "-u", "-m", "h2gcn_tpu_torch.run_experiments"]
        argv += dataset_args(args, split_job, fg_name, run_id)
        if epochs is not None:
            argv += ["--epochs", str(epochs)]
        if extra_args:
            # a bare string would char-split through list() — tokenize it
            if isinstance(extra_args, str):
                extra_args = extra_args.split()
            argv += list(extra_args)
        print(f"[run_model] {' '.join(argv)}")
        if dry_run:
            results.append((run_id, None))
            continue
        log_path = ws / "terminal_output.log"
        t0 = time.perf_counter()
        with open(log_path, "a") as log_f:
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            )
            for line in proc.stdout:
                sys.stdout.write(line)
                log_f.write(line)
            proc.wait()
        wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(
                proc.returncode, argv,
                f"see {log_path} for the child log",
            )
        for job_i in model_project.find_jobs({"run_id": run_id}):
            job_i.doc.update({"succeeded": True, "wall_s": wall_s})
        results.append((run_id, 0))
    return results


def model_experiments_finished(graph_job: Job, config: dict) -> bool:
    for split_job, fg_name, files, args, run_id in iter_runs(graph_job, config):
        ws = Path(split_job.workspace()) / WORKSPACE_ROOT
        if not ws.exists():
            return False
        model_project = get_project(str(ws))
        if not any(
            j.doc.get("succeeded", False)
            for j in model_project.find_jobs({"run_id": run_id})
        ):
            return False
    return True


def clean_workspace(graph_job: Job, config: dict):
    """Remove failed runs and runs whose split-file md5 no longer matches."""
    removed = []
    for feature_job, split_job, fg_name, files in generation.feature_split_iter(
        graph_job
    ):
        ws = Path(split_job.workspace()) / WORKSPACE_ROOT
        if not ws.exists():
            continue
        if all(split_job.isfile(f) for f in files):
            md5 = split_files_md5(split_job, files)
        else:
            md5 = None
        model_project = get_project(str(ws))
        for job_i in model_project:
            run_id = job_i.statepoint.get("run_id", "")
            base_id = (run_id[: -len("[tuning]")]
                       if run_id.endswith("[tuning]") else run_id)
            stale = md5 is None or not base_id.endswith(f"@{md5}")
            failed = not job_i.doc.get("succeeded", False)
            if stale or failed:
                shutil.rmtree(job_i.workspace(), ignore_errors=True)
                removed.append(run_id)
    return removed


def clear_workspace(graph_job: Job):
    """Delete ALL experiment workspaces under a graph job."""
    removed = []
    for feature_job, split_job, _, _ in generation.feature_split_iter(graph_job):
        ws = Path(split_job.workspace()) / "experiments"
        if ws.exists():
            shutil.rmtree(str(ws))
            removed.append(str(ws))
    return removed


def run_sweep(root, config, *, epochs=None, parallel=1, graph_filter=None,
              **kw):
    """Run the sweep over all (filtered) graph jobs in a project root."""
    if isinstance(config, (str, Path)):
        config = load_config(config)
    graph_filter = graph_filter or config.get("graph_filter_dict")
    kw["epochs"] = epochs
    project = get_project(str(root))
    jobs = [j for j in project if _graph_matches(j, graph_filter)]
    if parallel > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawn: a forked worker would inherit the caller's CUDA context.
        # An executor, not mp.Pool: a worker that dies (e.g. cannot start)
        # breaks the sweep with an error instead of being replaced forever
        with ProcessPoolExecutor(parallel,
                                 mp_context=mp.get_context("spawn")) as pool:
            futures = [pool.submit(_run_one, j.statepoint, str(root),
                                   config, kw) for j in jobs]
            for future in futures:
                future.result()
    else:
        for j in jobs:
            run_model(j, config, **kw)
    return jobs


def _run_one(statepoint, root, config, kw):
    project = get_project(root)
    job = project.open_job(statepoint)
    run_model(job, config, **kw)

"""Nested run-store hierarchy tools (the signac_tools equivalent).

Workspace hierarchy, identical in shape to the reference
(experiments/h2gcn/utils/signac_tools.py:4-83, README.md:50):

    <root>/workspace/<graph_job>/          — generated graph artifacts
        features/workspace/<feature_job>/  — feature matrices
            splits/workspace/<split_job>/  — planetoid split files
                experiments/<model>/workspace/<run_job>/ — training runs

Projects are created lazily per level; iterators skip ``disabled`` jobs.
The port's copy of ``h2gcn_tpu.experiments.store_tools``, on the port's
run store (the same job ids, so either package reads the other's project).
"""

from __future__ import annotations

from pathlib import Path

from ..modules.runstore import Job, Project, get_project


def get_feature_project(graph_job: Job) -> Project:
    return get_project(str(Path(graph_job.workspace()) / "features"))


def get_split_project(feature_job: Job) -> Project:
    return get_project(str(Path(feature_job.workspace()) / "splits"))


def get_model_project(split_job: Job, model_name: str) -> Project:
    return get_project(
        str(Path(split_job.workspace()) / "experiments" / model_name)
    )


def _iter_enabled(project, sp_filter=None, doc_filter=None):
    for job in project.find_jobs(sp_filter, doc_filter):
        if job.doc.get("disabled", False):
            continue
        yield job


def feature_iter(graph_job: Job, **filters):
    yield from _iter_enabled(get_feature_project(graph_job), **filters)


def split_iter(feature_job: Job, **filters):
    yield from _iter_enabled(get_split_project(feature_job), **filters)


def model_iter(split_job: Job, model_name: str, **filters):
    yield from _iter_enabled(get_model_project(split_job, model_name),
                             **filters)


def recursive_iter(graph_project: Project):
    """Yield (graph_job, feature_job, split_job) triples."""
    for g in graph_project:
        for f in feature_iter(g):
            for s in split_iter(f):
                yield g, f, s

"""Dataset generation pipeline: graphs → statistics → features → splits.

The run-store counterpart of the reference's signac-flow FlowProject
(experiments/h2gcn/run_graph_generation.py): each operation is idempotent —
its post-condition is checked from on-disk artifacts and ``succeeded`` doc
flags, so the pipeline is resumable and re-runs only missing work. Per-job
RNG is reseeded deterministically from the job id
(reference :24-31), so regeneration is reproducible.

Generation methods: ``mixhop`` (synthetic heterophily graphs), ``planetoid``
/ ``geomgcn`` / ``sparsegraph`` (re-export real datasets into the pipeline),
``copy``. The reference's ``exec(job.sp.preprocess)`` escape hatch
(:104-105, a code-injection hazard) is replaced by a whitelisted transform
registry (``SPARSEGRAPH_TRANSFORMS``).

The port's copy of ``h2gcn_tpu.experiments.generation``: the loaders are
the port's (``sparsegraph``, ``GeomGCNData``, ``PlanetoidData``), and the
per-job seeds come from the same job ids as the JAX package's, so both
packages generate the same project from the same config.
"""

from __future__ import annotations

import pickle
import random as _random
from pathlib import Path

import numpy as np
import scipy.sparse

from ..modules.runstore import Job, Project, get_project
from . import feature_generation, graph_stats, store_tools
from .feature_generation import PLANETOID_SUFFIXES
from .graphgen import GraphGenerator, MixhopGraphGenerator, adj_lists_to_scipy


def reset_random_state(job_id, extra=None) -> np.random.RandomState:
    seed_src = job_id if extra is None else (job_id, extra)
    np_seed = _random.Random(str(seed_src)).randrange(0, 2 ** 32)
    return np.random.RandomState(np_seed)


# --------------------------------------------------------------------- labels
def graph_generated(job: Job) -> bool:
    name = job.sp.graphName
    return all(
        job.isfile(f"{name}{ext}") for ext in (".graph", ".ally", ".gpickle.gz")
    )


def statistics_calculated(job: Job) -> bool:
    sd = graph_stats.stats_dict
    return all(k in job.doc for k, v in sd.items() if v[1]) and all(
        k in job.data for k, v in sd.items() if v[2]
    )


def load_graph_artifacts(job: Job):
    """(adj_lists, colors, ally) from a generated graph workspace."""
    name = job.sp.graphName
    with open(job.fn(f"{name}.graph"), "rb") as f:
        adj_lists = pickle.load(f)
    with open(job.fn(f"{name}.ally"), "rb") as f:
        ally = pickle.load(f)
    colors = np.zeros(len(ally), dtype=np.int64)
    idx, lab = np.nonzero(ally)
    colors[idx] = lab + 1
    return adj_lists, colors, np.asarray(ally)


# ----------------------------------------------------------------- operations
SPARSEGRAPH_TRANSFORMS = {}  # name → func(SparseGraph) -> SparseGraph


def _register_sparsegraph_transforms():
    SPARSEGRAPH_TRANSFORMS.update({
        "standardize": lambda g: g.standardize(),
        "to_undirected": lambda g: g.to_undirected(),
        "to_unweighted": lambda g: g.to_unweighted(),
    })


def generate_graph(job: Job, rng=None):
    if graph_generated(job):
        return
    rng = rng if rng is not None else reset_random_state(job.id)
    sp_ = job.sp
    method = sp_.method

    if method == "mixhop":
        gen = MixhopGraphGenerator(
            sp_.classRatio, sp_.get("heteroClsWeight", "circularDist"),
            hetero_weights_exponent=sp_.get("heteroWeightsExponent", 1.0),
            rng=rng,
        )
        adj_lists, colors = gen(sp_.numNode, sp_.m, sp_.m0, sp_.h)
        _save_all(gen, adj_lists, colors, job)
    elif method in ("planetoid", "geomgcn"):
        from ..datasets._dataset import GeomGCNData, PlanetoidData

        if method == "planetoid":
            ds = PlanetoidData(sp_.datasetName, sp_.source_path)
        else:
            ds = GeomGCNData(sp_.datasetName, sp_.source_path)
        _export_dataset(job, ds)
        # seed downstream feature/split jobs mirroring the original splits
        feature_job = store_tools.get_feature_project(job).open_job(
            {"feature_type": "unmodified"}
        ).init()
        allx = scipy.sparse.csr_matrix(ds.features)
        out = f"{sp_.graphName}-unmodified.allx.npz"
        scipy.sparse.save_npz(feature_job.fn(out), allx)
        feature_job.doc.update(dict(
            feature_file=out, feature_name=f"{sp_.datasetName}-unmodified",
            succeeded=True,
        ))
        if method == "planetoid":
            train_sizes = ds.y_all[ds.train_mask].sum(0)
            if len(np.unique(train_sizes)) == 1:
                train_word = f"{int(train_sizes[0])}c"
            else:
                train_word = str(int(ds.train_mask.sum()))
            split_config = f"{train_word}__{int(ds.test_mask.sum())}"
            split_job = store_tools.get_split_project(feature_job).open_job({
                "split_config": split_config
            }).init()
            # Preserve the CANONICAL planetoid split: copy the original
            # 8 files verbatim (reference copies them rather than
            # re-sampling; re-sampling would change published-split
            # results). Identity node mapping — the layout is unchanged.
            import json as _json
            import shutil as _shutil

            fg_name = f"{sp_.graphName}-unmodified-{split_config}"
            for ext in PLANETOID_SUFFIXES:
                _shutil.copy2(
                    Path(sp_.source_path) / f"{sp_.datasetName}.{ext}",
                    split_job.fn(f"{fg_name}.{ext}"),
                )
            with open(split_job.fn("node_mapping.json"), "w") as f:
                _json.dump({i: i for i in range(ds.num_samples)}, f)
            split_job.doc.update(dict(succeeded=True, split_name=fg_name))
    elif method == "sparsegraph":
        from ..datasets import sparsegraph as sgio

        _register_sparsegraph_transforms()
        g = sgio.load_npz_to_sparse_graph(
            str(Path(sp_.source_path) / f"{sp_.datasetName}.npz")
        )
        for t in sp_.get("preprocess", []):
            g = SPARSEGRAPH_TRANSFORMS[t](g) or g
        adj_lists, colors = _sparsegraph_to_lists(g)
        gen = GraphGenerator(sp_.numClass)
        _save_all(gen, adj_lists, colors, job)
        feature_job = store_tools.get_feature_project(job).open_job(
            {"feature_type": "unmodified"}
        ).init()
        if g.attr_matrix is not None:
            out = f"{sp_.graphName}-unmodified.allx.npz"
            scipy.sparse.save_npz(
                feature_job.fn(out), scipy.sparse.csr_matrix(g.attr_matrix)
            )
            feature_job.doc.update(dict(
                feature_file=out,
                feature_name=f"{sp_.datasetName}-unmodified", succeeded=True,
            ))
    elif method == "copy":
        src = Path(sp_.source_path)
        name = sp_.source_name
        with open(src / f"{name}.graph", "rb") as f:
            adj_lists = pickle.load(f)
        ally = np.load(src / f"{name}.ally", allow_pickle=True)
        ty = np.load(src / f"{name}.ty", allow_pickle=True)
        colors = np.zeros(len(adj_lists), dtype=np.int64)
        idx, lab = np.nonzero(ally)
        colors[idx] = lab + 1
        for i, line in enumerate(open(src / f"{name}.test.index")):
            node_id = int(line.strip())
            colors[node_id] = int(np.nonzero(ty[i])[0][0]) + 1
        adj_lists = {u: set(v) for u, v in adj_lists.items()}
        gen = GraphGenerator(sp_.numClass)
        _save_all(gen, adj_lists, colors, job)
    else:
        raise ValueError(f"Unknown generation method {method}")


def _save_all(gen: GraphGenerator, adj_lists, colors, job: Job):
    gen.save_graph(adj_lists, colors, job.workspace(), job.sp.graphName)
    gen.save_y(adj_lists, colors, job.workspace(), job.sp.graphName)
    gen.save_nx_graph(adj_lists, colors, job.workspace(), job.sp.graphName)


def _export_dataset(job: Job, ds):
    adj = ds.sparse_adj.tocsr()
    n = adj.shape[0]
    adj_lists = {
        i: set(adj.indices[adj.indptr[i]:adj.indptr[i + 1]].tolist())
        for i in range(n)
    }
    labels = ds.labels
    colors = np.asarray(labels) + 1  # -1 (unlabeled) → 0
    gen = GraphGenerator(ds.num_labels)
    gen.save_graph(adj_lists, colors, job.workspace(), job.sp.graphName)
    with open(job.fn(f"{job.sp.graphName}.ally"), "wb") as f:
        pickle.dump(np.asarray(ds.y_all), f)
    gen.save_nx_graph(adj_lists, colors, job.workspace(), job.sp.graphName)


def _sparsegraph_to_lists(g):
    adj = g.adj_matrix.tocsr()
    n = adj.shape[0]
    adj_lists = {
        i: set(adj.indices[adj.indptr[i]:adj.indptr[i + 1]].tolist())
        for i in range(n)
    }
    colors = (np.asarray(g.labels) + 1 if g.labels is not None
              else np.zeros(n, np.int64))
    return adj_lists, colors


def calculate_statistics(job: Job):
    if statistics_calculated(job):
        return
    adj_lists, colors, ally = load_graph_artifacts(job)
    adj = adj_lists_to_scipy(adj_lists)
    results = graph_stats.calculate_statistics(
        adj, colors, ally, statepoint=dict(job.statepoint)
    )
    for key, value in results.items():
        _, to_doc, to_data = graph_stats.stats_dict[key]
        if to_doc:
            job.doc[key] = (value.tolist() if isinstance(value, np.ndarray)
                            else value)
        if to_data:
            job.data[key] = (np.asarray(value) if value is not None
                             else np.zeros(0))


def generate_feature(job: Job, cora_source=None):
    """Materialize every feature job under a graph job."""
    for feature_job in store_tools.feature_iter(job):
        ftype = feature_job.sp.feature_type
        name = job.sp.graphName
        if ftype in ("naive", "naive_npz"):
            var = feature_job.sp.var_factor
            ext = ".allx.npz" if ftype == "naive_npz" else ".allx"
            out = f"{name}-{ftype}-{var}{ext}"
            if feature_job.isfile(out):
                continue
            _, _, ally = load_graph_artifacts(job)
            if var == "all":
                allx = ally
            elif var == "identity":
                allx = np.eye(ally.shape[0])
            else:
                raise NotImplementedError(var)
            if ftype == "naive_npz":
                scipy.sparse.save_npz(
                    feature_job.fn(out), scipy.sparse.csr_matrix(allx))
            else:
                np.save(open(feature_job.fn(out), "wb"), allx)
            feature_job.doc.update(dict(
                feature_file=out, feature_name=f"{ftype}-{var}",
                succeeded=True))
        elif ftype == "sample":
            stype = feature_job.sp.sample_type
            if stype != "cora_row":
                raise NotImplementedError(stype)
            out = f"{name}-{ftype}-{stype}.allx.npz"
            if feature_job.isfile(out):
                continue
            _, _, ally = load_graph_artifacts(job)
            source = cora_source
            if source is None:
                raise ValueError("cora_row sampling requires cora_source")
            class_size = np.sum(ally, axis=0)
            eligible = source.feature_sample_eligible(class_size)
            if not eligible:
                feature_job.doc["disabled"] = True
                feature_job.doc["disable_reason"] = (
                    f"{name} ineligible for cora_row sampling")
                continue
            rng = reset_random_state(job.id, out)
            allx = feature_generation.row_sample(ally, source, rng=rng)
            scipy.sparse.save_npz(
                feature_job.fn(out), scipy.sparse.csr_matrix(allx))
            feature_job.doc.update(dict(feature_file=out, succeeded=True))
        elif ftype == "unmodified":
            continue  # written by generate_graph
        else:
            raise ValueError(f"Unknown feature type {ftype}")


def feature_split_iter(job: Job):
    """Yield (feature_job, split_job, feature_graph_name, files)."""
    import os

    for feature_job in store_tools.feature_iter(job):
        feature_file = feature_job.doc.get("feature_file")
        feature_name = feature_job.doc.get("feature_name")
        for split_job in store_tools.split_iter(feature_job):
            split_config = split_job.sp.get("split_config", split_job.id)
            if feature_file:
                base = os.path.splitext(feature_file.replace(".npz", ""))[0]
                fg_name = f"{base}-{split_config}"
            elif feature_name:
                fg_name = f"{job.sp.graphName}-{feature_name}-{split_config}"
            else:
                continue
            files = [f"{fg_name}.{ext}" for ext in PLANETOID_SUFFIXES]
            yield feature_job, split_job, fg_name, files


def split_generated(job: Job) -> bool:
    any_split = False
    for _, split_job, _, files in feature_split_iter(job):
        if split_job.doc.get("disabled", False):
            continue
        any_split = True
        if not (split_job.doc.get("succeeded", False)
                and all(split_job.isfile(f) for f in files)):
            return False
    return any_split


def generate_split(job: Job):
    adj_lists, _, ally = load_graph_artifacts(job)
    for feature_job, split_job, fg_name, files in feature_split_iter(job):
        if split_job.doc.get("disabled", False):
            continue
        if split_job.doc.get("succeeded", False) and all(
            split_job.isfile(f) for f in files
        ):
            continue
        feature_file = feature_job.doc.get("feature_file")
        if feature_file is None:
            continue
        path = feature_job.fn(feature_file)
        if path.endswith(".npz"):
            allx = np.asarray(scipy.sparse.load_npz(path).todense())
        else:
            allx = np.load(path)
        rng = reset_random_state(job.id, (split_job.id, fg_name))
        tr_idx = te_idx = va_idx = None
        split_source = split_job.sp.get("split_source")
        if split_source:  # stored GeomGCN-style mask file → fixed indices
            with np.load(split_source) as masks:
                tr_idx = np.nonzero(masks["train_mask"])[0]
                va_idx = np.nonzero(masks["val_mask"])[0]
                te_idx = np.nonzero(masks["test_mask"])[0]
        result = feature_generation.generate_split(
            adj_lists, ally, allx, split_job.sp.get("split_config", ""),
            split_job.workspace(), fg_name, rng=rng,
            train_indices=tr_idx, test_indices=te_idx,
            validation_indices=va_idx,
        )
        if result is None:
            split_job.doc["disabled"] = True
            continue
        split_job.doc["val_size"] = result["val_size"]
        split_job.doc["succeeded"] = True
        split_job.doc["split_name"] = fg_name


# ------------------------------------------------------------------ pipeline
def init_project(root, config: dict) -> Project:
    """Create graph/feature/split jobs from a config dict.

    Config format::

        {"graphs": [{statepoint...}, ...],
         "features": [{feature statepoint}, ...],
         "splits": [{"split_config": "0.25p__0.5p"}, ...]}
    """
    project = get_project(root)
    for graph_sp in config.get("graphs", []):
        gjob = project.open_job(graph_sp).init()
        for fsp in config.get("features", []):
            fjob = store_tools.get_feature_project(gjob).open_job(fsp).init()
            for ssp in config.get("splits", []):
                store_tools.get_split_project(fjob).open_job(ssp).init()
    return project


def run_pipeline(root, config: dict = None, cora_source=None, verbose=True):
    """Init (optional) + run all operations to completion. Returns project."""
    project = (init_project(root, config) if config is not None
               else get_project(root))
    for job in project:
        if verbose:
            print(f"[pipeline] graph {job.id[:8]} ({job.sp.get('graphName')})")
        generate_graph(job)
        calculate_statistics(job)
        generate_feature(job, cora_source=cora_source)
        generate_split(job)
    return project

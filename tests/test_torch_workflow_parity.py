"""The port's pipeline against the JAX package's on one config.

The same generation config through both packages' ``init`` and
``generate`` gives the same job ids at every level and the same files
(features sampled from a synthetic Cora source, ``cora_row``, among them),
so the same run ids; a project generated by the JAX pipeline is swept by
the port's workflow and summarized alike by both packages. Also the twins
of ``tests/test_workflow.py``'s parallel sweep and GeomGCN re-export, whose
children train through ``h2gcn_tpu_torch.run_experiments`` on the CPU.
"""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from h2gcn_tpu.experiments import summarize as j_summarize
from h2gcn_tpu.experiments import workflow as j_workflow
from h2gcn_tpu.experiments.__main__ import main as j_exp_main
from h2gcn_tpu.modules.runstore import get_project as j_get_project
from h2gcn_tpu_torch.experiments import (
    generation,
    store_tools,
    summarize,
    workflow,
)
from h2gcn_tpu_torch.experiments.__main__ import main as exp_main
from h2gcn_tpu_torch.modules.runstore import get_project

CPU = "--device cpu"

GEN_CONFIG = {
    "graphs": [
        {
            "method": "mixhop", "numNode": 120, "numClass": 3,
            "classRatio": [40, 40, 40], "m": 2, "m0": 6, "h": h,
            "heteroClsWeight": "circularDist", "heteroWeightsExponent": 1.0,
            "graph_index": 1, "graphName": f"mixhop-n120-h{h}-c3-r1",
        }
        for h in (0.2, 0.8)
    ],
    "features": [{"feature_type": "naive_npz", "var_factor": "all"},
                 {"feature_type": "sample", "sample_type": "cora_row"}],
    "splits": [
        {"split_config": "0.25p__0.5p", "split_index": i} for i in range(2)
    ],
}

MODEL_CONFIG = {
    "model_args": [
        "H2GCN --network_setup M16-R-T1-G-V-C1-MO --adj_nhood 1 2 --hidden 16",
        "GCN --variant mlp --hidden1 8",
    ],
    "exp_regex": "naive_npz",
    "arg_regex": None,
    "graph_filter_dict": None,
}


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """The config through each package's CLI: (jax root, port root)."""
    root = tmp_path_factory.mktemp("parity")
    cora = root / "cora"
    # 3 classes of ~133 nodes: each covers a synthetic class of 40
    chip_smoke.write_planetoid(
        str(cora), "cora", chip_smoke.build_graph(n=400, m_edges=1200,
                                                  seed=5),
        seed=5, n_classes=3, train_per_class=20, n_test=100)
    gen_cfg = root / "gen.json"
    gen_cfg.write_text(json.dumps(GEN_CONFIG))
    roots = []
    for tag, main in (("jax", j_exp_main), ("torch", exp_main)):
        proj = str(root / tag)
        main(["init", proj, "-c", str(gen_cfg)])
        main(["generate", proj, "--cora_path", str(cora)])
        roots.append(proj)
    return tuple(roots)


def _tree(root):
    """Every generated file (not the sweeps' runs) by its relative path."""
    out = {}
    for path in sorted(Path(root).rglob("*")):
        if path.is_file() and "experiments" not in path.parts:
            data = path.read_bytes()
            if path.suffix == ".gz":  # gzip's header holds the write time
                data = gzip.decompress(data)
            out[str(path.relative_to(root))] = data
    return out


def test_init_and_generate_match_jax(projects):
    j_root, t_root = projects
    j_tree, t_tree = _tree(j_root), _tree(t_root)
    # the same job ids at every level (they name the workspace dirs) and
    # the same documents, statistics, graphs, features and split files
    assert sorted(t_tree) == sorted(j_tree)
    assert len([k for k in t_tree if k.endswith(".test.index")]) == 8
    assert any("sample-cora_row.allx.npz" in k for k in t_tree)
    for key in j_tree:
        assert t_tree[key] == j_tree[key], key
    t_ids = sorted(j.id for j in get_project(t_root))
    assert t_ids == sorted(j.id for j in j_get_project(j_root))


def test_run_ids_match_jax(projects):
    j_root, t_root = projects
    cfg = dict(MODEL_CONFIG, exp_regex="")
    for tuning in (False, True):
        ours = sorted(r[-1] for j in get_project(t_root)
                      for r in workflow.iter_runs(j, cfg, tuning))
        ref = sorted(r[-1] for j in j_get_project(j_root)
                     for r in j_workflow.iter_runs(j, cfg, tuning))
        # graphs x features x splits (tuning: split 0 only) x model_args
        assert ours == ref and len(ours) == 2 * 2 * (1 if tuning else 2) * 2


def test_port_sweeps_a_jax_project_summarized_alike(projects, tmp_path):
    j_root, _ = projects
    cfg = dict(MODEL_CONFIG, model_args=MODEL_CONFIG["model_args"][1:],
               graph_filter_dict={"h": 0.8})
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps(cfg))
    exp_main(["sweep", j_root, "-c", str(cfg_path), "--epochs", "4",
              "--extra_args", CPU])
    ours = summarize.summarize_experiments(j_root, cfg)
    ref = j_summarize.summarize_experiments(j_root, cfg)
    assert len(ours) == 2  # one graph, two splits, one model_args entry
    assert [list(r) for r in ours] == [list(r) for r in ref]
    assert ours == ref
    for row in ours:
        assert 0 <= row["test_accuracy"] <= 1 + 1e-5
    # the JAX package's workflow sees the port's runs as finished
    for job in j_get_project(j_root):
        if job.sp.h == 0.8:
            assert j_workflow.model_experiments_finished(job, cfg)


def test_run_sweep_parallel_workers(projects):
    _, root = projects
    cfg = dict(MODEL_CONFIG, model_args=["GCN --variant mlp --hidden1 8"])
    jobs = workflow.run_sweep(root, cfg, epochs=4, parallel=2,
                              extra_args=CPU)
    assert len(jobs) == 2
    for job in jobs:
        assert workflow.model_experiments_finished(job, cfg)
    assert len(summarize.summarize_experiments(root, cfg)) == 2 * 2
    for job in workflow.run_sweep(root, cfg, epochs=4, parallel=2,
                                  extra_args=CPU):
        assert workflow.model_experiments_finished(job, cfg)


def test_geomgcn_reexport_end_to_end(tmp_path):
    rng = np.random.RandomState(0)
    n, f, c = 36, 10, 3
    feats = (rng.rand(n, f) > 0.5).astype(int)
    labels = rng.randint(0, c, n)
    src = tmp_path / "raw"
    src.mkdir()
    with open(src / "out1_node_feature_label.txt", "w") as fh:
        fh.write("node_id\tfeature\tlabel\n")
        for i in range(n):
            fh.write(f"{i}\t{','.join(map(str, feats[i]))}\t{labels[i]}\n")
    edges = {(i, i + 1) for i in range(n - 1)}
    while len(edges) < 80:
        u, v = rng.randint(0, n, 2)
        if u != v:
            edges.add((u, v))
    with open(src / "out1_graph_edges.txt", "w") as fh:
        fh.write("src\tdst\n")
        for u, v in sorted(edges):
            fh.write(f"{u}\t{v}\n")
    mask_file = tmp_path / "split0.npz"
    perm = rng.permutation(n)
    np.savez(mask_file,
             train_mask=np.isin(np.arange(n), perm[:20]),
             val_mask=np.isin(np.arange(n), perm[20:28]),
             test_mask=np.isin(np.arange(n), perm[28:]))

    proj = get_project(str(tmp_path / "p"))
    job = proj.open_job({
        "method": "geomgcn", "datasetName": "toy",
        "source_path": str(src), "graphName": "toy-geomgcn",
        "numClass": c,
    }).init()
    generation.generate_graph(job)
    fjob = next(iter(store_tools.get_feature_project(job)))
    store_tools.get_split_project(fjob).open_job(
        {"split_source": str(mask_file)}).init()
    generation.generate_split(job)
    _, split_job, fg_name, files = next(iter(
        generation.feature_split_iter(job)))
    assert split_job.doc.get("succeeded")
    assert all(split_job.isfile(fl) for fl in files)

    cfg = dict(MODEL_CONFIG, exp_regex="",
               model_args=["H2GCN --network_setup M8-R-T1-G-V-C1-MO "
                           "--adj_nhood 1 --hidden 8"])
    results = workflow.run_model(job, cfg, epochs=3, extra_args=CPU)
    assert results and all(rc == 0 for _, rc in results)
    assert workflow.model_experiments_finished(job, cfg)

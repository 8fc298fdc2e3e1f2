"""The port's orchestration, end to end on the CPU: init → generate → sweep
→ summarize → clean, through ``python -m h2gcn_tpu_torch.experiments``'s
``main``.

Twins of ``tests/test_workflow.py``: a miniature syn-cora pipeline (2 tiny
graphs, 1 feature type, 2 splits, 2 model configs) whose children train
through ``h2gcn_tpu_torch.run_experiments`` on the CPU (``--extra_args
'--device cpu'``), with resumability and stale-run cleanup. Where the JAX
test reads Citeseer from the reference tree, the twin writes a synthetic
Planetoid source (``chip_smoke.write_planetoid``).
"""

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
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
            "graphName": f"mixhop-n120-h{h}-c3",
        }
        for h in (0.2, 0.8)
    ],
    "features": [{"feature_type": "naive_npz", "var_factor": "all"}],
    "splits": [
        {"split_config": "0.25p__0.5p", "split_index": i} for i in range(2)
    ],
}

MODEL_CONFIG = {
    "model_args": [
        "H2GCN --network_setup M16-R-T1-G-V-C1-MO --adj_nhood 1 2 --hidden 16",
        "GCN --variant gcn --hidden1 16",
    ],
    "exp_regex": "",
    "arg_regex": None,
    "graph_filter_dict": None,
}


@pytest.fixture(scope="module")
def pipeline_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    gen_cfg = root / "gen.json"
    gen_cfg.write_text(json.dumps(GEN_CONFIG))
    exp_main(["init", str(root / "proj"), "-c", str(gen_cfg)])
    exp_main(["generate", str(root / "proj")])
    return root


def test_generation_pipeline(pipeline_root):
    project = get_project(str(pipeline_root / "proj"))
    assert len(project) == 2
    for job in project:
        assert generation.graph_generated(job)
        assert generation.statistics_calculated(job)
        assert generation.split_generated(job)
        assert 0 <= job.doc["homoEdgeRatio"] <= 1
        assert job.doc["numNodes"] == 120
    jobs = sorted(project, key=lambda j: j.sp.h)
    assert jobs[0].doc["homoEdgeRatio"] < jobs[1].doc["homoEdgeRatio"]


def test_generation_idempotent(pipeline_root):
    project = get_project(str(pipeline_root / "proj"))
    job = next(iter(project))
    before = job.doc["homoEdgeRatio"]
    generation.run_pipeline(str(pipeline_root / "proj"), verbose=False)
    assert job.doc["homoEdgeRatio"] == before


def test_sweep_and_summarize(pipeline_root, tmp_path):
    cfg = tmp_path / "model.json"
    cfg.write_text(json.dumps(MODEL_CONFIG))
    root = str(pipeline_root / "proj")
    # two graph jobs: the spawned pool of -p 2 takes one each
    exp_main(["sweep", root, "-c", str(cfg), "--epochs", "8", "-p", "2",
              "--extra_args", f"{CPU} --timing"])

    rows = summarize.summarize_experiments(root, MODEL_CONFIG)
    assert len(rows) == 2 * 2 * 2  # graphs x splits x model_args
    for row in rows:
        assert row["test_accuracy"] is not None
        assert 0 <= row["test_accuracy"] <= 1 + 1e-5
        assert row["h"] in (0.2, 0.8)

    project = get_project(root)
    for job in project:
        assert workflow.model_experiments_finished(job, MODEL_CONFIG)
        assert workflow.run_model(job, MODEL_CONFIG, epochs=8) == []
        for split_job, _, _, _, run_id in workflow.iter_runs(job,
                                                             MODEL_CONFIG):
            ws = Path(split_job.workspace()) / workflow.WORKSPACE_ROOT
            (run,) = get_project(str(ws)).find_jobs({"run_id": run_id})
            # the child's seconds and its --timing record (a CPU run
            # launches no kernel)
            assert 0 < run.doc["timing"]["main_s"] < run.doc["wall_s"]
            assert run.doc["timing"]["prep_s"] > 0
            assert run.doc["timing"]["epochs"] == 8
            assert run.doc["timing"]["launches"] == {}

    out_csv = tmp_path / "results.csv"
    exp_main(["summarize", root, "-f", str(cfg), "-o", str(out_csv)])
    assert out_csv.exists()
    stats_csv = tmp_path / "stats.csv"
    exp_main(["stats", root, "-o", str(stats_csv)])
    assert stats_csv.exists()

    job = next(iter(project))
    _, split_job, fg_name, files = next(generation.feature_split_iter(job))
    with open(split_job.fn(files[0]), "ab") as f:
        f.write(b"stale")
    removed = workflow.clean_workspace(job, MODEL_CONFIG)
    assert len(removed) >= 1
    assert not workflow.model_experiments_finished(job, MODEL_CONFIG)


def test_run_sweep_forwards_epochs(pipeline_root, capsys):
    root = str(pipeline_root / "proj")
    workflow.run_sweep(root, dict(MODEL_CONFIG, model_args=["GCN"]),
                       epochs=7, dry_run=True)
    assert "--epochs 7" in capsys.readouterr().out


def test_child_argv_runs_the_port_cli(pipeline_root, capsys):
    root = str(pipeline_root / "proj")
    jobs = workflow.run_sweep(root, dict(MODEL_CONFIG, model_args=["GCN"]),
                              extra_args=CPU, dry_run=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[run_model] ")]
    assert len(lines) == 2 * len(jobs)  # one a split, both graphs
    for line in lines:
        argv = line.split()[1:]
        assert argv[1:4] == ["-u", "-m", "h2gcn_tpu_torch.run_experiments"]
        assert argv[4:6] == ["GCN", "planetoid"]
        assert argv[-2:] == ["--device", "cpu"]
        assert "h2gcn_tpu.run_experiments" not in argv


def test_clean_workspace_keeps_succeeded_tuning_runs(pipeline_root):
    proj = get_project(str(pipeline_root / "proj"))
    graph_job = next(iter(proj))
    cfg = {"model_args": ["H2GCN --network_setup M16-MO"]}
    runs = list(workflow.iter_runs(graph_job, cfg, tuning=True))
    assert runs, "expected at least one tuning run candidate"
    split_job, fg_name, files, args, run_id = runs[0]
    assert run_id.endswith("[tuning]")
    ws = Path(split_job.workspace()) / workflow.WORKSPACE_ROOT
    ws.mkdir(parents=True, exist_ok=True)
    mp = get_project(str(ws))
    mp.open_job({"run_id": run_id}).init().doc["succeeded"] = True
    removed = workflow.clean_workspace(graph_job, cfg)
    assert run_id not in removed
    assert any(j.doc.get("succeeded")
               for j in mp.find_jobs({"run_id": run_id}))


def test_planetoid_reexport_preserves_canonical_split(tmp_path):
    src_path = str(tmp_path / "raw")
    chip_smoke.write_planetoid(
        src_path, "synciteseer", chip_smoke.build_graph(n=300, m_edges=900,
                                                        seed=4),
        seed=4, n_classes=6, train_per_class=5, n_test=100)
    proj = get_project(str(tmp_path / "p"))
    job = proj.open_job({
        "method": "planetoid", "datasetName": "ind.synciteseer",
        "source_path": src_path, "graphName": "citeseer-export",
        "numClass": 6,
    }).init()
    generation.generate_graph(job)
    found = list(generation.feature_split_iter(job))
    assert found, "planetoid export should seed a feature/split job"
    _, split_job, fg_name, files = found[0]
    assert fg_name == "citeseer-export-unmodified-5c__100"
    assert split_job.doc.get("succeeded")
    assert all(split_job.isfile(f) for f in files)
    with open(split_job.fn(f"{fg_name}.y"), "rb") as f:
        y_new = pickle.load(f)
    with open(os.path.join(src_path, "ind.synciteseer.y"), "rb") as f:
        y_src = pickle.load(f, encoding="latin1")
    assert np.array_equal(np.asarray(y_new), np.asarray(y_src))
    with open(split_job.fn("node_mapping.json")) as f:
        assert all(int(k) == v for k, v in json.load(f).items())


def test_generate_split_stored_split_source(tmp_path):
    n, c = 30, 3
    masks = np.zeros((3, n), dtype=bool)
    for i in range(n):
        masks[i % 3, i] = True
    mask_file = tmp_path / "split0.npz"
    np.savez(mask_file, train_mask=masks[0], val_mask=masks[1],
             test_mask=masks[2])
    proj = get_project(str(tmp_path / "p"))
    job = proj.open_job({
        "method": "mixhop", "numNode": n, "numClass": c,
        "classRatio": [10, 10, 10], "m": 2, "m0": 6, "h": 0.5,
        "graphName": "g30",
    }).init()
    generation.generate_graph(job)
    fjob = store_tools.get_feature_project(job).open_job(
        {"feature_type": "naive_npz", "var_factor": "all"}).init()
    store_tools.get_split_project(fjob).open_job(
        {"split_source": str(mask_file)}).init()
    generation.generate_feature(job)
    generation.generate_split(job)
    _, split_job, fg_name, files = next(iter(
        generation.feature_split_iter(job)))
    assert split_job.doc.get("succeeded")
    assert split_job.doc["val_size"] == int(masks[1].sum())
    _, _, ally_g = generation.load_graph_artifacts(job)
    with open(split_job.fn(f"{fg_name}.ty"), "rb") as f:
        ty = pickle.load(f)
    assert np.array_equal(ty, ally_g[np.nonzero(masks[2])[0]])


def test_parallel_sweep_raises_a_failed_child(pipeline_root):
    # no fallback: a child that fails raises in the caller, through the
    # spawned pool as without it
    import subprocess

    cfg = dict(MODEL_CONFIG, model_args=["GCN --variant no_such_variant"])
    with pytest.raises(subprocess.CalledProcessError):
        workflow.run_sweep(str(pipeline_root / "proj"), cfg, epochs=1,
                           parallel=2, extra_args=CPU)

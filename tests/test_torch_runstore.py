"""The PyTorch port's run store against the JAX package's.

A statepoint gets the same job id in both packages; a project written by
either package is read by the other (documents, statepoints and arrays
bitwise); and a CLI run with ``--use_signac --save_activations
--save_predictions --deg_acc_monitor`` records the same job (same id: the
two CLIs share every flag without a leading underscore) with the keys the
JAX package's run records, in the original node order under
``--reorder``."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from h2gcn_tpu.modules import runstore as j_store
from h2gcn_tpu.run_experiments import main as j_main
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.modules import runstore as t_store

NAME = "store"

STATEPOINTS = [
    {},
    {"model": "H2GCN", "lr": 0.01},
    {"lr": 0.01, "model": "H2GCN"},  # key order does not matter
    {"adj_nhood": ["1", "2"], "dropout": 0.5, "use_signac": True,
     "save_predictions": [True], "deg_acc_monitor": [2.0, 5.0],
     "early_stopping": 0, "checkpoint_dir": None},
    {"nested": {"b": 1, "a": [1, 2.5, "x"]}, "unicode": "é", "big": 1e-30},
    {"callable": slice(1, 3)},  # not JSON: its str() is hashed
]


@pytest.mark.parametrize("statepoint", STATEPOINTS,
                         ids=range(len(STATEPOINTS)))
def test_calc_id_matches_jax(statepoint):
    assert t_store.calc_id(statepoint) == j_store.calc_id(statepoint)
    assert len(t_store.calc_id(statepoint)) == 32


@pytest.mark.parametrize("writer,reader", [(j_store, t_store),
                                           (t_store, j_store)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_a_project_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                             reader):
    rng = np.random.default_rng(0)
    arrays = {"activations/0-dense": rng.random((5, 3)).astype(np.float32),
              "predicted_prob": rng.random((5, 2)),
              "train_mask": np.array([1, 0, 1, 0, 0], np.float32),
              "deg_acc/test/counts": np.array([3, 2])}
    wp = writer.get_project(str(tmp_path))
    for lr in (0.01, 0.02):
        job = wp.open_job({"model": "H2GCN", "lr": lr}).init()
        job.doc["succeeded"] = lr == 0.01
        job.doc.update({"exp_tags": ["a", "b"]})
        for key, value in arrays.items():
            job.data[key] = value
        with open(job.fn("results.json"), "w") as f:
            json.dump({"val_acc": lr}, f)

    rp = reader.get_project(str(tmp_path))
    assert len(rp) == 2
    found = list(rp.find_jobs({"lr": 0.01}, {"succeeded": True}))
    assert len(found) == 1
    job = found[0]
    assert job.id == writer.calc_id({"model": "H2GCN", "lr": 0.01})
    assert job.sp.model == "H2GCN" and job.sp["lr"] == 0.01
    assert job.doc["exp_tags"] == ["a", "b"]
    assert set(job.data.keys()) == set(arrays)
    for key, value in arrays.items():
        got = job.data[key]
        assert got.dtype == value.dtype
        np.testing.assert_array_equal(got, value)
    assert job.isfile("results.json")
    assert list(rp.find_jobs(doc_filter={"succeeded": False}))[0].sp.lr == 0.02


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=240, m_edges=700, seed=6)
    chip_smoke.write_planetoid(path, NAME, adj, seed=6, n_feat=40,
                               feats_per_row=4, n_test=60, n_classes=3,
                               train_per_class=8)
    return path


def _argv(data_dir, root, *extra):
    return ["H2GCN", "planetoid", "--dataset", f"ind.{NAME}",
            "--dataset_path", data_dir, "--epochs", "3", "--hidden", "8",
            "--val_size", "60", "--use_signac", "--signac_root", str(root),
            "--save_activations", "--save_predictions", "1",
            "--deg_acc_monitor", "2", "5", "--run_id", "fixed", *extra]


def test_cli_records_the_jax_packages_job(data_dir, tmp_path):
    t_args = run_experiments.main(_argv(data_dir, tmp_path / "t",
                                        "--device", "cpu"))
    j_args = j_main(_argv(data_dir, tmp_path / "j"))
    t_job, j_job = t_args.objects["signac_job"], j_args.objects["signac_job"]
    assert t_job.id == j_job.id
    assert t_job.statepoint == json.loads(json.dumps(
        j_job.statepoint, default=str))
    assert set(t_job.data.keys()) == set(j_job.data.keys())
    assert any(k.startswith("activations/") for k in t_job.data.keys())
    for key in j_job.data.keys():
        assert t_job.data[key].shape == j_job.data[key].shape, key
    for key in ("train_mask", "val_mask", "test_mask", "inputs/inputs",
                "deg_acc/test/bins", "deg_acc/test/counts"):
        np.testing.assert_array_equal(t_job.data[key], j_job.data[key])
    with open(t_job.fn("results.json")) as f:
        t_res = json.load(f)
    with open(j_job.fn("results.json")) as f:
        j_res = json.load(f)
    assert set(t_res) == set(j_res)
    assert t_res["epoch"] == t_args.objects["best_val_stats"]["epoch"]
    assert isinstance(t_res["val_acc"], float)
    # the final checkpoint lives in the job's workspace
    assert list((tmp_path / "t" / "workspace" / t_job.id /
                 "checkpoints").glob("*/ckpt.pt"))
    # the recorded predictions are the restored model's logits
    tensors = t_args.objects["tensors"]
    logits = t_args.objects["predict_step"](**tensors)
    np.testing.assert_array_equal(t_job.data["predicted_prob"],
                                  logits.numpy())


def test_recorded_arrays_are_in_the_original_node_order(data_dir, tmp_path):
    """Under --reorder every stored per-node array is in the original node
    order; sparse input features are stored as their CSR arrays."""
    args = run_experiments.main(_argv(data_dir, tmp_path, "--device", "cpu",
                                      "--reorder", "rcm",
                                      "--sparse_features"))
    job, tensors = args.objects["signac_job"], args.objects["tensors"]
    perm = tensors["node_perm"]
    assert not np.array_equal(perm, np.arange(perm.size))
    dataset = args.objects["dataset"]
    for scope in ("train", "val", "test"):
        np.testing.assert_array_equal(
            job.data[f"{scope}_mask"],
            np.asarray(getattr(dataset, f"{scope}_mask"), np.float32))
    # row perm[i] of a training-order array is node perm[i]'s
    logits = args.objects["predict_step"](**tensors).numpy()
    np.testing.assert_array_equal(job.data["predicted_prob"][perm], logits)
    capture = {}
    with torch.no_grad():
        args.objects["model"](tensors["adj"], tensors["features"],
                              tensors["adj_hops"], capture=capture)
    features = capture.pop("inputs/inputs").to_scipy()
    stored = sp.csr_matrix(
        tuple(job.data[f"inputs/inputs/{k}"] for k in
              ("data", "indices", "indptr")),
        shape=tuple(job.data["inputs/inputs/shape"]))
    assert abs(stored[perm] - features).nnz == 0
    for key, value in capture.items():
        np.testing.assert_array_equal(job.data[key][perm], value.numpy())

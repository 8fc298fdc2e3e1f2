"""The slice as a whole on the CPU: planetoid files -> exact-hop tensors ->
H2GCN-2 training, in the PyTorch port and in the JAX package.

The same synthetic planetoid directory (written by chip_smoke.py's writer)
feeds both packages: the hop matrices, features and masks must agree, five
dropout-free train steps from the same carried weights must give the JAX
runtime's losses at rtol 2e-5, and the port's CLI must train end to end
and resume from its checkpoint."""

import glob
import os
from argparse import Namespace
from collections import deque

import numpy as np
import pytest
import torch

import chip_smoke
from h2gcn_tpu.datasets._dataset import PlanetoidData as JPlanetoidData
from h2gcn_tpu.models import _runtime as j_runtime
from h2gcn_tpu.nn import NetworkModel as JNetworkModel
from h2gcn_tpu.nn import parse_network_setup as j_parse
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.datasets._dataset import PlanetoidData
from h2gcn_tpu_torch.models import _runtime as t_runtime
from h2gcn_tpu_torch.nn import NetworkModel, load_jax_params, parse_network_setup

NAME = "syn"
SETUP = "M64-R-T1-G-V-T2-G-V-C1-C2-MO"  # H2GCN-2 without dropout


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=800, m_edges=2400, seed=3)
    chip_smoke.write_planetoid(path, NAME, adj, seed=3, n_feat=300,
                               feats_per_row=6, n_test=200)
    return path


def _datasets(data_dir):
    out = []
    for cls in (JPlanetoidData, PlanetoidData):
        ds = cls(f"ind.{NAME}", data_dir, val_size=500)
        ds.row_normalize_features()
        ds.adj_remove_eye()
        out.append(ds)
    return out


def test_get_tensors_match_jax(data_dir):
    jds, tds = _datasets(data_dir)
    jt = jds.get_tensors(get_adj_norm_hops=["1", "2"], backend="segment")
    tt = tds.get_tensors(get_adj_norm_hops=["1", "2"], backend="segment")
    assert len(tt.adj_hops) == len(jt.adj_hops) == 2
    for a, b in zip(tt.adj_hops + [tt.adj], jt.adj_hops + [jt.adj]):
        diff = a.to_scipy() - b.to_scipy()
        assert a.nnz == b.nnz
        assert abs(diff).max() <= 1e-7
    for key in ("features", "y_train", "y_val", "y_test", "train_mask",
                "val_mask", "test_mask", "labels"):
        np.testing.assert_array_equal(getattr(tt, key).numpy(),
                                      np.asarray(getattr(jt, key)),
                                      err_msg=key)
    assert float(tt.train_mask.sum()) == 140  # 20 per class, 7 classes


def _args(ds, tensors):
    return Namespace(
        objects={"dataset": ds, "tensors": vars(tensors),
                 "post_epoch_callbacks": deque(),
                 "post_train_callbacks": deque()},
        random_seed=123, grad_monitor=False, verbose=False, use_signac=False,
        deg_acc_monitor=[], best_val_criteria="val_acc", current_epoch=0)


@pytest.mark.parametrize("backend", ["segment", "gscatter", "bsr"])
def test_train_steps_match_jax_runtime(data_dir, backend):
    jds, tds = _datasets(data_dir)
    n_labels = jds.num_labels
    jargs = _args(jds, jds.get_tensors(get_adj_norm_hops=["1", "2"],
                                       backend="segment"))
    j_runtime.initialize_model(jargs, JNetworkModel(
        j_parse(SETUP, n_labels), l2_regularize_weight=5e-4), "adam", 0.01, 0)
    targs = _args(tds, tds.get_tensors(get_adj_norm_hops=["1", "2"],
                                       backend=backend))
    model = NetworkModel(parse_network_setup(SETUP, n_labels),
                         l2_regularize_weight=5e-4)
    t_runtime.initialize_model(targs, model, "adam", 0.01, 0)
    load_jax_params(model, [{k: np.asarray(v) for k, v in p.items()}
                            for p in jargs.objects["state"]["params"]])
    j_losses, t_losses = [], []
    for epoch in range(1, 6):
        jargs.current_epoch = targs.current_epoch = epoch
        j_losses.append(float(jargs.objects["train_step"](
            **jargs.objects["tensors"])["train_loss"]))
        t_losses.append(float(targs.objects["train_step"](
            **targs.objects["tensors"])["train_loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-5, atol=2e-6)
    j_stats = jargs.objects["test_step"](**jargs.objects["tensors"])
    t_stats = targs.objects["test_step"](**targs.objects["tensors"])
    for key in ("val_loss", "test_loss", "train_acc", "val_acc",
                "test_accuracy"):
        np.testing.assert_allclose(float(t_stats[key]), float(j_stats[key]),
                                   rtol=2e-5, atol=2e-6, err_msg=key)


def test_cli_trains_and_resumes(data_dir, tmp_path, capsys):
    base = ["H2GCN", "planetoid", "--dataset", f"ind.{NAME}",
            "--dataset_path", data_dir, "--device", "cpu",
            "--sparse_backend", "gscatter"]
    args = run_experiments.main(
        base + ["--epochs", "3", "--checkpoint_dir", str(tmp_path / "a")])
    assert args.current_epoch == 3
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(float(args.objects["epoch_stats"][key]))
    best = args.objects["best_val_stats"]
    ckpts = glob.glob(str(tmp_path / "a" / "*" / "ckpt.pt"))
    assert len(ckpts) == 1 and f"_{best['epoch']:04d}_" in ckpts[0]
    assert "Best performance:" in capsys.readouterr().out

    # the checkpoint holds the restored best state; resuming loads it
    saved = torch.load(ckpts[0], weights_only=True)
    model = args.objects["model"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(saved["params"][k], v)
    capsys.readouterr()
    resumed = run_experiments.main(
        base + ["--epochs", "1", "--checkpoint_dir", str(tmp_path / "b"),
                "--restore_checkpoint", os.path.dirname(ckpts[0]),
                "--ckpt_every_epoch", "--grad_monitor",
                "--deg_acc_monitor", "2", "5"])
    assert resumed.objects["optimizer"].state_dict()["state"][0]["count"] == (
        saved["opt_state"]["state"][0]["count"] + 1)
    out = capsys.readouterr().out
    assert "Gradient range: [kernels.0]" in out
    assert "[deg_acc_monitor - [2.0, 5.0]" in out
    assert glob.glob(str(tmp_path / "b" / "*" / "ckpt.pt"))

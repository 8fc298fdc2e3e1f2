"""Blocked epochs (``--epochs_per_block K``) in the PyTorch port on the CPU.

The same small planetoid directory (written by chip_smoke.py's writer)
feeds every run. The port's blocked and per-epoch runs must select the
same best epoch with the same best state (parameters at atol 1e-6, the
optimizer's state and its host-resolved step counts too) over three
seeds, with dropout on: the blocked path draws from the one dropout
generator in the per-epoch order. The early-stop deviation is held to
the JAX package's contract. From carried weights and without dropout, a
block's stacked stats match the JAX package's ``train_block`` at rtol
2e-5 (atol 2e-6)."""

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

NAME = "blk"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=300, m_edges=900, seed=4)
    chip_smoke.write_planetoid(path, NAME, adj, seed=4, n_feat=60,
                               feats_per_row=5, n_test=100, n_classes=3,
                               train_per_class=10)
    return path


def _run(data_dir, tmp_path, tag, *extra):
    return run_experiments.main([
        "H2GCN", "planetoid", "--dataset", f"ind.{NAME}", "--dataset_path",
        data_dir, "--device", "cpu", "--hidden", "16", "--val_size", "80",
        "--checkpoint_dir", str(tmp_path / tag), *extra])


def _same_state(a, b, atol=1e-6):
    for key, ref in a["params"].items():
        torch.testing.assert_close(b["params"][key], ref, atol=atol, rtol=0)
    sa, sb = a["opt_state"], b["opt_state"]
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        assert st["count"] == sb["state"][i]["count"]
        for key in ("m", "v"):
            torch.testing.assert_close(sb["state"][i][key], st[key],
                                       atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [123, 42, 7])
def test_blocked_selects_the_per_epoch_best(data_dir, tmp_path, seed,
                                            capsys):
    common = ["--epochs", "14", "--random_seed", str(seed), "--lr", "0.05"]
    a = _run(data_dir, tmp_path, "a", *common)
    # blocks of 4, 4, 4 and a shrunken tail of 2
    b = _run(data_dir, tmp_path, "b", *common, "--epochs_per_block", "4",
             "--timing")
    out = capsys.readouterr().out
    assert "===> Blocked training: 14 epochs" in out
    assert "===> Timing (blocked):" in out and "block(s) of 4" in out
    assert [k for k, _ in b.objects["block_times"]] == [4, 4, 4, 2]
    ba, bb = a.objects["best_val_stats"], b.objects["best_val_stats"]
    assert ba["epoch"] == bb["epoch"]
    for key in ("val_acc", "val_loss", "test_accuracy", "train_loss"):
        np.testing.assert_allclose(float(bb[key]), float(ba[key]),
                                   rtol=0, atol=1e-6)
    _same_state(a.objects["best_state"], b.objects["best_state"])
    # the best epoch's Adam counts, resolved on the host after the readback
    assert {st["count"] for st in
            b.objects["best_state"]["opt_state"]["state"].values()} == {
                ba["epoch"]}
    # post_train restored the best state into the model in both runs
    for key, value in a.objects["model"].state_dict().items():
        torch.testing.assert_close(b.objects["model"].state_dict()[key],
                                   value, atol=1e-6, rtol=0)


def test_blocked_stats_match_the_per_epoch_lines(data_dir, tmp_path):
    """Every epoch's stat line and the val_loss criterion's selection."""
    common = ["--epochs", "9", "--best_val_criteria", "val_loss"]
    lines = []
    for extra in ([], ["--epochs_per_block", "3"]):
        with chip_smoke.RecordedEpochs() as rec:
            args = _run(data_dir, tmp_path, str(len(lines)), *common, *extra)
        lines.append((rec.epochs, args))
    (ea, a), (eb, b) = lines
    assert [e for e, _ in ea] == [e for e, _ in eb] == list(range(1, 10))
    for (_, sa), (_, sb) in zip(ea, eb):
        for key, value in sa.items():
            np.testing.assert_allclose(sb[key], value, rtol=0, atol=1e-6)
    assert (a.objects["best_val_stats"]["epoch"]
            == b.objects["best_val_stats"]["epoch"])
    _same_state(a.objects["best_state"], b.objects["best_state"])


def test_blocked_early_stop_deviation_contract(data_dir, tmp_path):
    """When the sliding-mean controller fires mid-block, the blocked run
    may process up to K-1 more epochs; its selection is over a superset of
    the per-epoch run's epochs, so its best criterion is no worse."""
    K = 8
    common = ["--epochs", "200", "--early_stopping", "5", "--lr", "0.1",
              "--best_val_criteria", "val_loss"]
    a = _run(data_dir, tmp_path, "e1", *common)
    b = _run(data_dir, tmp_path, "e2", *common, "--epochs_per_block", str(K))
    stop1, stop2 = int(a.epochs), int(b.epochs)
    assert stop1 < 200, "early stopping must fire for this test"
    assert stop1 <= stop2 < stop1 + K
    assert b.current_epoch == stop2
    b1, b2 = a.objects["best_val_stats"], b.objects["best_val_stats"]
    assert float(b2["val_loss"]) <= float(b1["val_loss"]) + 1e-7
    if b1["epoch"] == b2["epoch"]:
        _same_state(a.objects["best_state"], b.objects["best_state"])


def test_blocked_is_ignored_with_pre_epoch_callbacks(data_dir, tmp_path,
                                                     capsys):
    """GraphSAGE's batch re-mask runs before every epoch: the blocked loop
    steps aside, as in the JAX package; so does --profile_dir."""
    run_experiments.main([
        "GRAPHSAGE", "planetoid", "--dataset", f"ind.{NAME}",
        "--dataset_path", data_dir, "--device", "cpu", "--epochs", "2",
        "--batch_size", "8", "--hid_units", "8", "--epochs_per_block", "2",
        "--checkpoint_dir", str(tmp_path / "sage")])
    assert "--epochs_per_block ignored" in capsys.readouterr().out
    args = _run(data_dir, tmp_path, "prof", "--epochs", "2",
                "--epochs_per_block", "2", "--profile_dir",
                str(tmp_path / "trace"))
    out = capsys.readouterr().out
    assert "--profile_dir is a per-epoch-loop feature" in out
    assert "Blocked training: 2 epochs" in out
    assert not (tmp_path / "trace").exists()
    assert args.objects["block_times"][0][0] == 2


def _args(ds, tensors):
    return Namespace(
        objects={"dataset": ds, "tensors": vars(tensors),
                 "post_epoch_callbacks": deque(),
                 "post_train_callbacks": deque()},
        random_seed=123, grad_monitor=False, verbose=False, use_signac=False,
        deg_acc_monitor=[], best_val_criteria="val_loss", current_epoch=0)


def test_block_stats_match_jax_train_block(data_dir):
    """Two blocks (4 epochs, then 2) of dropout-free H2GCN-2 from the same
    weights through both packages' train_block."""
    setup = "M16-R-T1-G-V-T2-G-V-C1-C2-MO"
    dsets = []
    for cls in (JPlanetoidData, PlanetoidData):
        ds = cls(f"ind.{NAME}", data_dir, val_size=80)
        ds.row_normalize_features()
        ds.adj_remove_eye()
        dsets.append(ds)
    jds, tds = dsets
    jargs = _args(jds, jds.get_tensors(get_adj_norm_hops=["1", "2"],
                                       backend="segment"))
    j_runtime.initialize_model(jargs, JNetworkModel(
        j_parse(setup, jds.num_labels), l2_regularize_weight=5e-4),
        "adam", 0.01, 0)
    targs = _args(tds, tds.get_tensors(get_adj_norm_hops=["1", "2"],
                                       backend="segment"))
    model = NetworkModel(parse_network_setup(setup, tds.num_labels),
                         l2_regularize_weight=5e-4)
    t_runtime.initialize_model(targs, model, "adam", 0.01, 0)
    load_jax_params(model, [{k: np.asarray(v) for k, v in p.items()}
                            for p in jargs.objects["state"]["params"]])
    start = 1
    for k in (4, 2):
        js = jargs.objects["train_block"](k, start, **jargs.objects["tensors"])
        ts = targs.objects["train_block"](k, start, **targs.objects["tensors"])
        assert set(ts) == set(js) == set(t_runtime.BLOCK_STATS)
        for key, ref in js.items():
            assert ts[key].shape == (k,)
            np.testing.assert_allclose(ts[key], ref, rtol=2e-5, atol=2e-6,
                                       err_msg=key)
        start += k

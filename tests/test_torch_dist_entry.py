"""The port's entry points of the distributed layer on the CPU: the
CLI's rank launcher (``--mesh_shards N`` spawns N gloo ranks from one
command), a failing rank that fails the command instead of hanging it,
the one-GPU-a-rank check made before anything spawns, and
``h2gcn_tpu_torch.entry`` (the counterpart of the JAX package's root
``__graft_entry__.py``: the forward step and the dry run in every mode)."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from h2gcn_tpu_torch import entry, run_experiments
from h2gcn_tpu_torch.parallel import mesh as pmesh

NAME = "dent"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=200, m_edges=600, seed=6)
    chip_smoke.write_planetoid(path, NAME, adj, seed=6, n_feat=40,
                               feats_per_row=4, n_test=60, n_classes=3,
                               train_per_class=8)
    return path


def _argv(data_dir, tmp_path, *extra):
    return ["H2GCN", "planetoid", "--dataset", f"ind.{NAME}",
            "--dataset_path", data_dir, "--device", "cpu", "--epochs", "6",
            "--val_size", "50", "--lr", "0.05", "--network_setup",
            "M16-R-T1-G-V-T2-G-V-C1-C2-MO",
            "--checkpoint_dir", str(tmp_path / "ck"), *extra]


def test_cli_spawns_its_ranks(data_dir, tmp_path):
    """One command, two ranks: rank 0's best epoch comes back, equal to
    the one-process run's."""
    ref = run_experiments.main(_argv(data_dir, tmp_path / "one"))
    got = run_experiments.main(_argv(data_dir, tmp_path / "two",
                                     "--mesh_shards", "2"))
    assert not torch.distributed.is_initialized()  # the parent joins none
    best, ref_best = got.objects["best_val_stats"], ref.objects[
        "best_val_stats"]
    assert best["epoch"] == ref_best["epoch"]
    np.testing.assert_allclose(best["test_accuracy"],
                               float(ref_best["test_accuracy"]), atol=1e-5)
    np.testing.assert_allclose(best["val_loss"], float(ref_best["val_loss"]),
                               rtol=1e-4)
    assert len(os.listdir(tmp_path / "two" / "ck")) == 1


def test_a_failing_rank_fails_the_command(data_dir, tmp_path):
    """A setup without graph layers has no hop matrices to shard: every
    rank raises, and the command raises the rank's error."""
    argv = _argv(data_dir, tmp_path, "--mesh_shards", "2")
    argv[argv.index("M16-R-T1-G-V-T2-G-V-C1-C2-MO")] = "M16-R-D0.5-MO"
    with pytest.raises(Exception, match="requires hop-matrix models"):
        run_experiments.main(argv)


def test_more_ranks_than_gpus_fail_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        pmesh.check_devices(2, "cuda")
    pmesh.check_devices(1, "cuda")
    pmesh.check_devices(16, "cpu")

    def never(*a, **kw):
        raise AssertionError("spawned")

    monkeypatch.setattr(torch.multiprocessing, "start_processes", never)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        pmesh.spawn(print, 2, "cuda")


def test_entry_forward_step():
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert out.shape == (256, 7) and torch.isfinite(out).all()
    assert out.device.type == "cpu"


def test_dryrun_multichip_every_mode():
    losses = entry.dryrun_multichip(2, "cpu")
    assert set(losses) == set(entry._DRYRUN_MODES)
    assert all(np.isfinite(v) for v in losses.values())


def test_dryrun_joins_a_world_of_one():
    """``dryrun.run(1)`` outside any world joins one for the call."""
    from h2gcn_tpu_torch.parallel import dryrun

    out = dryrun.run(1, mode="halo-cootile", device="cpu")
    assert not torch.distributed.is_initialized()
    assert np.isfinite(out["loss"]) and "kernels.0" in out["params"]


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip", "dryrun"])
def test_entry_points_run_on_the_gpu_by_default(monkeypatch, call):
    """With no device asked for, the entry points take the GPU: without
    one they raise, and none falls back to the CPU or spawns a rank."""
    from h2gcn_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)

    def never(*a, **kw):
        raise AssertionError("spawned")

    monkeypatch.setattr(torch.multiprocessing, "start_processes", never)
    if call == "entry":
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            entry.entry()
    elif call == "dryrun_multichip":
        with pytest.raises(ValueError, match="requested 2 devices, have 0"):
            entry.dryrun_multichip(2)
    else:
        with pytest.raises(ValueError, match="requested 1 devices, have 0"):
            dryrun.run(1, mode="ring")
    assert not torch.distributed.is_initialized()

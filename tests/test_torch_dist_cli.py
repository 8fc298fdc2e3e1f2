"""``--mesh_shards 2`` through the port's CLI on the CPU (gloo ranks).

One spawned world of two ranks runs ``run_experiments.main`` on each
argv in turn (each rank already belongs to a world of 2, so the CLI
spawns nothing more): H2GCN-2 in the four ``--halo_mode``s (halo in
blocks of 5 epochs; halo-cootile recorded in the run store) and GAT, on a
synthetic planetoid directory (``chip_smoke.write_planetoid``). Each run
is dropout-free, so the final best epoch's stats must match the same argv
without ``--mesh_shards`` here: the same best epoch, its accuracies at
1e-5 and its losses at rtol 1e-4. Each rank runs from a directory of its
own: rank 0 writes the checkpoints and the run store, rank 1 nothing.
"""

import os

import numpy as np
import pytest

import chip_smoke
import torch_dist_worker as worker
from h2gcn_tpu_torch import run_experiments
from h2gcn_tpu_torch.parallel.mesh import spawn

NAME = "dcli"
SETUP = "M16-R-T1-G-V-T2-G-V-C1-C2-MO"
RUNS = {
    "ring": ("H2GCN", "--network_setup", SETUP, "--halo_mode", "ring"),
    "allgather": ("H2GCN", "--network_setup", SETUP, "--halo_mode",
                  "allgather"),
    "halo_blocked": ("H2GCN", "--network_setup", SETUP, "--halo_mode",
                     "halo", "--epochs", "10", "--epochs_per_block", "5"),
    "halo-cootile": ("H2GCN", "--network_setup", SETUP, "--halo_mode",
                     "halo-cootile", "--use_signac", "--signac_root",
                     "store"),
    "gat": ("GAT", "--in_drop", "0", "--attn_drop", "0",
            "--fused_attention", "--attn_impl", "gather"),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=300, m_edges=900, seed=4)
    chip_smoke.write_planetoid(path, NAME, adj, seed=4, n_feat=60,
                               feats_per_row=5, n_test=100, n_classes=3,
                               train_per_class=10)
    return path


def argv(data_dir, run, *extra):
    model, *rest = RUNS[run]
    return [model, "planetoid", "--dataset", f"ind.{NAME}",
            "--dataset_path", data_dir, "--device", "cpu", "--epochs", "8",
            "--val_size", "80", "--lr", "0.05", "--random_seed", "3",
            "--checkpoint_dir", f"ck/{run}", *rest, *extra]


@pytest.fixture(scope="module")
def dist_runs(data_dir, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ranks"))
    argvs = [argv(data_dir, run, "--mesh_shards", "2") for run in RUNS]
    stats = spawn(worker.cli_runs, 2, "cpu", argvs, base)
    return base, dict(zip(RUNS, stats))


@pytest.fixture(scope="module")
def single_runs(data_dir, tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("single"))
    try:
        return {run: run_experiments.main(argv(data_dir, run)).objects[
            "best_val_stats"] for run in RUNS}
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_matches_single_rank(dist_runs, single_runs, run):
    got, ref = dist_runs[1][run], single_runs[run]
    assert got["epoch"] == ref["epoch"]
    for key in ("train_acc", "val_acc", "test_accuracy"):
        np.testing.assert_allclose(got[key], float(ref[key]), atol=1e-5,
                                   err_msg=key)
    for key in ("val_loss", "test_loss", "train_loss"):
        np.testing.assert_allclose(got[key], float(ref[key]), rtol=1e-4,
                                   err_msg=key)


def test_rank_zero_owns_every_file(dist_runs):
    base, stats = dist_runs
    assert os.listdir(os.path.join(base, "rank1")) == []
    rank0 = os.path.join(base, "rank0")
    assert sorted(os.listdir(os.path.join(rank0, "ck"))) == sorted(
        r for r in RUNS if r != "halo-cootile")
    for run in ("ring", "gat"):
        # the final checkpoint, under the best epoch's name
        (name,) = os.listdir(os.path.join(rank0, "ck", run))
        assert f"_{stats[run]['epoch']:04d}_" in name
        assert os.path.isfile(os.path.join(rank0, "ck", run, name,
                                           "ckpt.pt"))


def test_run_store_holds_the_distributed_predictions(dist_runs):
    """The halo-cootile run's job: results.json, and the predictions of
    every node (gathered from both ranks) with the masks."""
    base, stats = dist_runs
    ws = os.path.join(base, "rank0", "store", "workspace")
    (job,) = os.listdir(ws)
    data = os.path.join(ws, job, "data")
    assert os.path.isfile(os.path.join(ws, job, "results.json"))
    probs = np.load(os.path.join(data, "predicted_prob.npy"))
    assert probs.shape == (300, 3) and np.isfinite(probs).all()
    mask = np.load(os.path.join(data, "test_mask.npy"))
    assert mask.shape == (300,) and mask.sum() == 100
    (name,) = os.listdir(os.path.join(ws, job, "checkpoints"))
    assert f"_{stats['halo-cootile']['epoch']:04d}_" in name


@pytest.mark.parametrize("run", list(RUNS))
def test_world_of_one_matches_single_rank(data_dir, single_runs, tmp_path,
                                          monkeypatch, run):
    """The distributed runtime at world size 1 (``chip_smoke.world_of_one``:
    ``_initialize_distributed(..., mesh_shards=1)`` on an in-process gloo
    world of one, as the smoke runs it over NCCL) against the one-device
    run: the same best epoch and stats."""
    import torch.distributed as tdist

    from h2gcn_tpu_torch.parallel.mesh import init_group

    monkeypatch.chdir(tmp_path)
    init_group(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu")
    try:
        with chip_smoke.world_of_one():
            args = run_experiments.main(argv(data_dir, run))
    finally:
        tdist.destroy_process_group()
    assert "dist_data" in args.objects  # the distributed runtime ran
    got, ref = args.objects["best_val_stats"], single_runs[run]
    assert got["epoch"] == ref["epoch"]
    for key in ("train_acc", "val_acc", "test_accuracy"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   atol=1e-5, err_msg=key)
    for key in ("val_loss", "test_loss", "train_loss"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-4, err_msg=key)

"""The PyTorch port's inference entry points against the JAX package's:
``h2gcn_tpu_torch.predict``, ``attn_step`` and ``embed_step``.

Each pair of runs reads the same small planetoid directory (chip_smoke.py's
writer); the port's model carries the JAX model's weights, so both compute
the same function: predictions at 1e-5, attention coefficients on the real
edges at 1e-5, embeddings at 1e-5."""

import glob

import numpy as np
import pytest
import torch

import chip_smoke
from h2gcn_tpu.predict import main as j_predict
from h2gcn_tpu.run_experiments import main as j_main
from h2gcn_tpu_torch import predict, run_experiments
from h2gcn_tpu_torch.models import _runtime
from h2gcn_tpu_torch.models.GRAPHSAGE import load_jax_graphsage_params
from h2gcn_tpu_torch.modules import checkpoint
from h2gcn_tpu_torch.nn import load_jax_gat_params, load_jax_params

NAME = "pred"
TOL = 1e-5


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("planetoid"))
    adj = chip_smoke.build_graph(n=260, m_edges=800, seed=8)
    chip_smoke.write_planetoid(path, NAME, adj, seed=8, n_feat=50,
                               feats_per_row=5, n_test=60, n_classes=4,
                               train_per_class=8)
    return path


def _argv(model, data_dir, tmp_path, tag, *extra):
    return [model, "planetoid", "--dataset", f"ind.{NAME}", "--dataset_path",
            data_dir, "--val_size", "60",
            "--checkpoint_dir", str(tmp_path / tag), *extra]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_predict_matches_jax_predict(data_dir, tmp_path):
    h2 = ("--hidden", "16", "--network_setup",
          "M16-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO")
    j_main(_argv("H2GCN", data_dir, tmp_path, "jck", "--epochs", "3", *h2))
    ck = glob.glob(str(tmp_path / "jck" / "*" / "ckpt.npz"))[0]
    j_out = tmp_path / "j.npz"
    jargs = j_predict(_argv("H2GCN", data_dir, tmp_path, "jp", *h2,
                            "--restore_checkpoint", ck, "--output",
                            str(j_out)))
    # the JAX run's weights in a port checkpoint
    targs = run_experiments.main(_argv("H2GCN", data_dir, tmp_path, "tb",
                                       "--device", "cpu", "--epochs", "0",
                                       *h2))
    load_jax_params(targs.objects["model"],
                    _numpy(jargs.objects["state"]["params"]))
    path = tmp_path / "tck" / checkpoint.CKPT_FILE
    checkpoint.save_state(path, _runtime.snapshot(targs.objects["model"],
                                                  targs.objects["optimizer"]))
    t_out = tmp_path / "t.npz"
    predict.main(_argv("H2GCN", data_dir, tmp_path, "tp", *h2, "--device",
                       "cpu", "--restore_checkpoint", str(path.parent),
                       "--output", str(t_out)))
    j, t = np.load(j_out), np.load(t_out)
    assert set(t.files) == set(j.files) == {
        "logits", "predicted_prob", "predicted_label", "train_mask",
        "val_mask", "test_mask"}
    _close(t["logits"], j["logits"])
    _close(t["predicted_prob"], j["predicted_prob"])
    assert t["predicted_prob"].dtype == np.float32
    np.testing.assert_array_equal(t["predicted_label"], j["predicted_label"])
    for key in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(t[key], j[key])


def test_predict_runs_on_the_card_unless_asked_for_the_cpu(data_dir,
                                                           tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict.main(_argv("H2GCN", data_dir, tmp_path, "x"))
    # without a checkpoint: the fresh initialization (a smoke test)
    out = tmp_path / "fresh.npz"
    predict.main(_argv("H2GCN", data_dir, tmp_path, "y", "--device", "cpu",
                       "--output", str(out)))
    d = np.load(out)
    assert d["logits"].shape == (260, 4)
    np.testing.assert_allclose(d["predicted_prob"].sum(1), 1.0, atol=1e-5)


def _gat_pair(data_dir, tmp_path, *extra):
    gat = ("--epochs", "1", "--hid_units", "4", "--n_heads", "2", "1")
    jargs = j_main(_argv("GAT", data_dir, tmp_path, "jg", *gat))
    targs = run_experiments.main(_argv("GAT", data_dir, tmp_path, "tg",
                                       "--device", "cpu", *gat, *extra))
    load_jax_gat_params(targs.objects["model"],
                        _numpy(jargs.objects["state"]["params"]))
    return jargs, targs


@pytest.mark.parametrize("payload", [(), ("--fused_attention",
                                          "--attn_impl", "gather")],
                         ids=["segment", "gather"])
def test_attn_step_matches_jax(data_dir, tmp_path, payload):
    """JAX's test_gat_attn_step: one [heads, edges] tensor a layer, each
    destination's coefficients summing to 1 over its real edges. The
    gather payload materializes them too (its plain versions here)."""
    jargs, targs = _gat_pair(data_dir, tmp_path, *payload)
    j_coefs = jargs.objects["attn_step"](**jargs.objects["tensors"])
    t_coefs = targs.objects["attn_step"](**targs.objects["tensors"])
    adj = targs.objects["tensors"]["adj"]
    nnz = adj.nnz
    assert len(t_coefs) == len(j_coefs) == 2
    assert [c.shape[0] for c in t_coefs] == [2, 1]
    rows = adj.rows[:nnz].long()
    for t, j in zip(t_coefs, j_coefs):
        _close(t[:, :nnz], np.asarray(j)[:, :nnz])
        sums = torch.zeros(adj.shape[0], t.shape[0]).index_add_(
            0, rows, t[:, :nnz].T)
        _close(sums, np.ones(sums.shape))


def test_attn_step_raises_without_coefficients(data_dir, tmp_path):
    args = run_experiments.main(_argv("H2GCN", data_dir, tmp_path, "h",
                                      "--device", "cpu", "--epochs", "1"))
    with pytest.raises(NotImplementedError, match="NetworkModel"):
        args.objects["attn_step"](**args.objects["tensors"])


def test_gat_embeddings_match_jax(data_dir, tmp_path):
    jargs, targs = _gat_pair(data_dir, tmp_path, "--fused_attention")
    got = targs.objects["embed_step"](**targs.objects["tensors"])
    ref = jargs.objects["embed_step"](**jargs.objects["tensors"])
    assert got.shape == (260, 8)
    _close(got, ref)


def test_graphsage_full_neighbor_embeddings_match_jax(data_dir, tmp_path):
    sage = ("--epochs", "1", "--hid_units", "8", "--num_samples", "0", "0")
    jargs = j_main(_argv("GRAPHSAGE", data_dir, tmp_path, "js", *sage))
    targs = run_experiments.main(_argv("GRAPHSAGE", data_dir, tmp_path, "ts",
                                       "--device", "cpu", *sage))
    load_jax_graphsage_params(targs.objects["model"],
                              _numpy(jargs.objects["state"]["params"]))
    got = targs.objects["embed_step"](**targs.objects["tensors"])
    ref = jargs.objects["embed_step"](**jargs.objects["tensors"])
    assert got.shape == (260, 8)
    _close(got, ref)


def test_dsl_embeddings_match_jax(data_dir, tmp_path):
    """H2GCN's embed_step returns the E-marked dense layer's output; the bp
    variant of GCN has none, as in the JAX package."""
    setup = ("--hidden", "8", "--network_setup",
             "M8-E-R-T1-G-V-T2-G-V-C1-C2-MO", "--epochs", "1")
    jargs = j_main(_argv("H2GCN", data_dir, tmp_path, "je", *setup))
    targs = run_experiments.main(_argv("H2GCN", data_dir, tmp_path, "te",
                                       "--device", "cpu", *setup))
    load_jax_params(targs.objects["model"],
                    _numpy(jargs.objects["state"]["params"]))
    got = targs.objects["embed_step"](**targs.objects["tensors"])
    ref = jargs.objects["embed_step"](**jargs.objects["tensors"])
    assert got.shape == (260, 8)
    _close(got, ref)
    bp = run_experiments.main(_argv(
        "GCN", data_dir, tmp_path, "bp", "--device", "cpu", "--variant",
        "bp", "--feature_configs", "labels", "--epochs", "1"))
    with pytest.raises(NotImplementedError):
        bp.objects["embed_step"](**bp.objects["tensors"])

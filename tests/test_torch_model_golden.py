"""The PyTorch port's H2GCN models against the executed TF2 reference
goldens (tests/golden, read-only), with the reference weights carried
through the JAX package's parameter list and load_jax_params.

Forward activations and logits at 1e-5, loss terms and accuracy as in
tests/test_golden_reference.py, and 10 dropout-free keras-Adam steps whose
losses match the reference at rtol 2e-5: H2GCN-2 on Cora, and as
parametrised cases H2GCN-1 on Cora, H2GCN-2 on Citeseer and with the hop
groups ``0,1;2`` (forward and loss), and H2GCN-1's dynamics."""

import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu.nn import NetworkModel as JNetworkModel
from h2gcn_tpu.nn import parse_network_setup as j_parse
from h2gcn_tpu_torch.models._runtime import KerasAdam
from h2gcn_tpu_torch.nn import NetworkModel, load_jax_params, parse_network_setup
from h2gcn_tpu_torch.nn.metrics import masked_accuracy
from h2gcn_tpu_torch.sparse import SparseMatrix

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    path = os.path.join(GOLDEN_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f"golden dump {path} not present")
    return np.load(path)


def _sparse_from(npz, prefix):
    idx = npz[f"{prefix}/indices"]
    vals = npz[f"{prefix}/values"]
    shape = tuple(int(s) for s in npz[f"{prefix}/dense_shape"])
    return sp.coo_matrix((vals, (idx[:, 0], idx[:, 1])), shape=shape).tocsr()


def _ref_activations(npz):
    out = []
    for key in npz.files:
        if key.startswith("activations/"):
            ind, name = key.split("/", 1)[1].split("-", 1)
            out.append((int(ind), name, npz[key]))
    return sorted(out)


def _jax_params(npz, setup, n_feat, n_hops):
    """The JAX model's parameter list with the reference weights placed."""
    conf = j_parse(setup, npz["tensors/y_train"].shape[1], _dense_units=64,
                   _dropout_rate=0.5)
    params = JNetworkModel(conf).init(jax.random.PRNGKey(0), n_feat, n_hops)
    params = [dict(p) for p in params]
    for ind, name, _ in _ref_activations(npz):
        wkey = f"weights/h2gcn/{name}/kernel:0"
        if wkey in npz.files:
            params[ind] = {"kernel": npz[wkey]}
            bkey = f"weights/h2gcn/{name}/bias:0"
            if bkey in npz.files:
                params[ind]["bias"] = npz[bkey]
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _port_model(npz):
    setup = str(npz["meta/network_setup"])
    feats = _sparse_from(npz, "inputs/inputs")
    n_hops = len({k.split("/")[2] for k in npz.files
                  if k.startswith("inputs/adjhops/")})
    conf = parse_network_setup(setup, npz["tensors/y_train"].shape[1],
                               _dense_units=64, _dropout_rate=0.5)
    model = NetworkModel(conf, l2_regularize_weight=5e-4)
    model.init(feats.shape[1], n_hops, torch.Generator().manual_seed(0))
    load_jax_params(model, _jax_params(npz, setup, feats.shape[1], n_hops))
    hops = [SparseMatrix.from_scipy(_sparse_from(npz, f"inputs/adjhops/{h}"),
                                    backend="segment")
            for h in range(n_hops)]
    x = torch.from_numpy(feats.toarray().astype(np.float32))
    return model, x, hops


def _t(npz, key):
    return torch.from_numpy(np.asarray(npz[key], dtype=np.float32))


def _check_forward(npz):
    model, x, hops = _port_model(npz)
    capture = {}
    with torch.no_grad():
        logits = model(hops[0], x, hops, capture=capture)
    for ind, name, ref_act in _ref_activations(npz):
        ours = capture[f"activations/{ind}-{model.names[ind]}"].numpy()
        np.testing.assert_allclose(
            ours, ref_act, rtol=1e-5, atol=1e-5,
            err_msg=f"layer {ind} ({name}) diverges from reference TF2")
    np.testing.assert_allclose(logits.numpy(), npz["predictions"],
                               rtol=1e-5, atol=1e-5)


def test_forward_matches_reference_tf2():
    _check_forward(_load("ref_h2gcn2_cora.npz"))


def _check_loss_and_accuracy(npz):
    model, x, hops = _port_model(npz)
    with torch.no_grad():
        logits = model(hops[0], x, hops)
        np.testing.assert_allclose(float(model.l2_loss()),
                                   npz["golden/l2_loss"], rtol=1e-5, atol=1e-7)
        loss = model.loss(logits, _t(npz, "tensors/y_train"),
                          _t(npz, "tensors/train_mask"))
        np.testing.assert_allclose(float(loss), npz["golden/train_loss"],
                                   rtol=1e-5)
        acc = masked_accuracy(logits, _t(npz, "tensors/y_test"),
                              _t(npz, "tensors/test_mask"))
        np.testing.assert_allclose(float(acc), npz["golden/test_acc"],
                                   rtol=0, atol=1e-6)


def test_loss_and_accuracy_match_reference_tf2():
    _check_loss_and_accuracy(_load("ref_h2gcn2_cora.npz"))


def _check_training_dynamics(npz):
    assert str(npz["meta/optimizer"]) == "adam"
    model, x, hops = _port_model(npz)
    y_train = _t(npz, "tensors/y_train")
    train_mask = _t(npz, "tensors/train_mask")
    opt = KerasAdam(model.parameters(), float(npz["meta/effective_lr"]))
    losses = []
    for _ in range(len(npz["golden/step_losses"])):
        opt.zero_grad()
        loss = model.loss(model(hops[0], x, hops), y_train, train_mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, npz["golden/step_losses"],
                               rtol=2e-5, atol=2e-6)
    for ind, name, _ in _ref_activations(npz):
        wkey = f"weights_after/h2gcn/{name}/kernel:0"
        if wkey in npz.files:
            np.testing.assert_allclose(
                model.kernels[str(ind)].detach().numpy(), npz[wkey],
                rtol=1e-4, atol=1e-6,
                err_msg=f"post-training kernel {name} diverges")


def test_training_dynamics_match_reference_tf2():
    _check_training_dynamics(_load("ref_dyn_h2gcn2_cora.npz"))


MORE_GOLDENS = ["ref_h2gcn1_cora.npz", "ref_h2gcn2_citeseer.npz",
                "ref_h2gcn2_cora_hopgroups.npz"]


@pytest.mark.parametrize("name", MORE_GOLDENS)
def test_forward_matches_more_references_tf2(name):
    _check_forward(_load(name))


@pytest.mark.parametrize("name", MORE_GOLDENS)
def test_loss_and_accuracy_match_more_references_tf2(name):
    _check_loss_and_accuracy(_load(name))


@pytest.mark.parametrize("name", ["ref_dyn_h2gcn1_cora.npz"])
def test_training_dynamics_match_more_references_tf2(name):
    _check_training_dynamics(_load(name))

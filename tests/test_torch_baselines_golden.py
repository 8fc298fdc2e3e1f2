"""The PyTorch port's baselines against the executed reference goldens
(tests/golden, read-only), at the tolerances of the JAX package's golden
tests (tests/test_golden_{gcn,mixhop,graphsage}_baseline.py).

- GCN family (TF1 GCN: gcn, gcn_cheby, dense, gcn_concat_2, and gcn on
  citeseer): every dumped activation, the logits, the train loss (masked CE
  plus the halved first-layer weight decay) and the test accuracy; 25 TF1
  Adam steps of gcn.
- MixHop (TF1, the published Cora setup): both layers' activations, the
  psum logits, the label and total losses, the test accuracy; 10 SGD steps
  and the weights after them.
- GraphSAGE (the reference PyTorch model, full-neighbor mean; plain and
  Concat): logits, train loss, test accuracy, encoder 1's output; 10 SGD
  steps and the weights after them.

The reference weights enter through the port's loaders of the JAX
package's parameter layouts (``load_jax_params``,
``load_jax_mixhop_params``, ``load_jax_graphsage_params``).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch.models import GCN as tgcn
from h2gcn_tpu_torch.models import GRAPHSAGE as tsage
from h2gcn_tpu_torch.models import MIXHOP as tmix
from h2gcn_tpu_torch.models._runtime import KerasAdam
from h2gcn_tpu_torch.nn import NetworkModel, load_jax_params
from h2gcn_tpu_torch.nn.metrics import (masked_accuracy,
                                        masked_softmax_cross_entropy)
from h2gcn_tpu_torch.sparse import SparseMatrix

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    path = os.path.join(GOLDEN_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f"golden dump {path} not present")
    return np.load(path)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _sparse_from(npz, prefix):
    idx = npz[f"{prefix}/indices"]
    vals = npz[f"{prefix}/values"]
    shape = tuple(int(s) for s in npz[f"{prefix}/dense_shape"])
    return sp.coo_matrix((vals, (idx[:, 0], idx[:, 1])), shape=shape).tocsr()


# --------------------------------------------------------------------- GCN
# ref model key -> (our variant, our layer index -> the reference kernels
# stacked into it, dumped activation index -> our layer index); the last
# dumped activation is the logits
GCN_CASES = {
    "gcn": ("gcn", {1: ["0/weights_0"], 6: ["1/weights_0"]}, {0: 4}),
    "gcn_cheby": ("cheby", {3: [f"0/weights_{k}" for k in range(4)],
                            8: [f"1/weights_{k}" for k in range(4)]},
                  {0: 4}),
    "dense": ("mlp", {1: ["0/weights"], 4: ["1/weights"]}, {0: 2}),
    "gcn_concat_2": ("concat2", {1: ["0/weights"], 4: ["1/weights_0"],
                                 9: ["2/weights_0"], 15: ["3/weights"]},
                     {0: 2, 1: 7, 2: 12, 3: 13}),
    "gcn_citeseer": ("gcn", {1: ["0/weights_0"], 6: ["1/weights_0"]},
                     {0: 4}),
}


def _gcn_file(case):
    ds = "citeseer" if case.endswith("_citeseer") else "cora"
    return f"ref_gcnbase_{case.removesuffix('_citeseer')}_{ds}.npz"


def _gcn_build(npz, case):
    variant, kernels, _ = GCN_CASES[case]
    num_labels = npz["tensors/y_train"].shape[1]
    model = NetworkModel(
        tgcn.build_layer_setups(variant, int(npz["meta/hidden1"]), 0.5,
                                num_labels),
        l2_regularize_weight=float(npz["meta/weight_decay"]))
    feats = _sparse_from(npz, "inputs/features")
    hops = [SparseMatrix.from_scipy(_sparse_from(npz, f"inputs/support/{k}"),
                                    backend="segment")
            for k in range(int(npz["meta/num_supports"]))]
    model.init(feats.shape[1], len(hops), torch.Generator().manual_seed(0))
    # the JAX package's per-layer list, the reference kernels placed
    params = [{} for _ in range(model.num_layers)]
    for ind, keys in kernels.items():
        params[ind] = {"kernel": np.vstack([npz[f"weights/{k}"]
                                            for k in keys])}
    load_jax_params(model, params)
    x = _t(feats.toarray())
    return model, x, hops


@pytest.mark.parametrize("case", sorted(GCN_CASES))
def test_gcn_forward_matches_reference_tf1(case):
    npz = _load(_gcn_file(case))
    model, x, hops = _gcn_build(npz, case)
    capture = {}
    with torch.no_grad():
        logits = model(hops[0] if hops else None, x, hops, capture=capture)
    for ref_i, our_i in GCN_CASES[case][2].items():
        ours = capture[f"activations/{our_i}-{model.names[our_i]}"].numpy()
        np.testing.assert_allclose(
            ours, npz[f"activations/{ref_i}"], rtol=1e-5, atol=1e-5,
            err_msg=f"{case}: ref activation {ref_i} vs our layer {our_i}")
    n_acts = len([k for k in npz.files if k.startswith("activations/")])
    np.testing.assert_allclose(logits.numpy(),
                               npz[f"activations/{n_acts - 1}"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), npz["predictions"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(GCN_CASES))
def test_gcn_loss_and_accuracy_match_reference_tf1(case):
    npz = _load(_gcn_file(case))
    model, x, hops = _gcn_build(npz, case)
    with torch.no_grad():
        logits = model(hops[0] if hops else None, x, hops)
        loss = model.loss(logits, _t(npz["tensors/y_train"]),
                          _t(npz["tensors/train_mask"]))
        acc = masked_accuracy(logits, _t(npz["tensors/y_test"]),
                              _t(npz["tensors/test_mask"]))
    np.testing.assert_allclose(float(loss), npz["golden/train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(acc), npz["golden/test_acc"], rtol=0,
                               atol=1e-6)


def test_gcn_training_dynamics_match_reference_tf1():
    """25 dropout-free steps of TF1's Adam (eps 1e-8, the bias corrections
    folded into the step size: the keras rule) from the reference init."""
    npz = _load("ref_gcnbase_dyn_gcn_cora.npz")
    model, x, hops = _gcn_build(npz, "gcn")
    y_train = _t(npz["tensors/y_train"])
    train_mask = _t(npz["tensors/train_mask"])
    opt = KerasAdam(model.parameters(), float(npz["meta/learning_rate"]),
                    eps=1e-8)
    losses = []
    for _ in range(len(npz["golden/step_losses"])):
        opt.zero_grad()
        loss = model.loss(model(hops[0], x, hops), y_train, train_mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, npz["golden/step_losses"],
                               rtol=2e-5, atol=2e-6)


# ------------------------------------------------------------------ MixHop
def _mixhop_build(npz):
    powers = [int(p) for p in npz["meta/powers"]]
    capacities = [[int(c) for c in row] for row in npz["meta/capacities"]]
    model = tmix.MixHopNetwork(
        powers, capacities, int(npz["meta/num_classes"]),
        l2reg=float(npz["meta/l2reg"]), input_dropout=0.5, layer_dropout=0.9)
    x = _t(npz["inputs/x_dense"])
    model.init(x.shape[1], 1, torch.Generator().manual_seed(0))
    params = {
        "layers": [{str(p): npz[f"weights/l{j}_p{p}/dense/kernel:0"]
                    for p in powers} for j in range(len(capacities))],
        "bn": [{"beta": npz["weights/batch_normalization/beta:0"]}, {}],
        "psum_q": npz["weights/psum_q:0"],
    }
    tmix.load_jax_mixhop_params(model, params)
    adj = _sparse_from(npz, "inputs/adj")
    support = SparseMatrix.from_scipy(adj, backend="segment")
    n = x.shape[0]
    masks = {}
    for scope in ("train", "test"):
        m = np.zeros(n, np.float32)
        m[npz[f"tensors/{scope}_idx"]] = 1
        masks[scope] = torch.from_numpy(m)
    return model, x, support, _t(npz["tensors/ally"]), masks


def test_mixhop_forward_and_losses_match_reference_tf1():
    npz = _load("ref_mixhopbase_cora.npz")
    model, x, support, ally, masks = _mixhop_build(npz)
    capture = {}
    with torch.no_grad():
        logits = model(support, x, [support], capture=capture)
        label_loss = masked_softmax_cross_entropy(logits, ally,
                                                  masks["train"])
        total = label_loss + model.l2_loss()
        acc = masked_accuracy(logits, ally, masks["test"])
    # ref activations: 6 = layer 0 after batch norm and ReLU, 8 = layer 1,
    # 9 = the psum logits
    for ours, ref in (("activations/0-mixhop", 6), ("activations/1-mixhop", 8),
                      ("activations/output-psum", 9)):
        np.testing.assert_allclose(capture[ours].numpy(),
                                   npz[f"activations/{ref}"], rtol=1e-5,
                                   atol=1e-5, err_msg=ours)
    np.testing.assert_allclose(float(label_loss), npz["golden/label_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(total), npz["golden/total_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(acc), npz["golden/test_acc"], rtol=0,
                               atol=1e-6)


def test_mixhop_training_dynamics_match_reference_tf1():
    npz = _load("ref_mixhopbase_cora.npz")
    model, x, support, ally, masks = _mixhop_build(npz)
    opt = torch.optim.SGD(model.parameters(), lr=float(npz["meta/lr"]))
    losses = []
    for _ in range(len(npz["golden/step_losses"])):
        opt.zero_grad()
        logits = model(support, x, [support])
        loss = (masked_softmax_cross_entropy(logits, ally, masks["train"])
                + model.l2_loss())
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, npz["golden/step_losses"], rtol=1e-4,
                               atol=1e-5)
    for j, kernels in enumerate(model.kernels):
        for p, w in kernels.items():
            np.testing.assert_allclose(
                w.detach().numpy(),
                npz[f"weights_after/l{j}_p{p}/dense/kernel:0"], rtol=1e-3,
                atol=2e-5, err_msg=f"post-training kernel l{j}_p{p}")
    np.testing.assert_allclose(model.psum_q.detach().numpy(),
                               npz["weights_after/psum_q:0"], rtol=1e-3,
                               atol=2e-5)


# --------------------------------------------------------------- GraphSAGE
SAGE_CASES = {"plain": ("ref_sagebase_plain_cora.npz", False),
              "concat": ("ref_sagebase_concat_cora.npz", True)}


def _sage_build(case):
    name, concat_jk = SAGE_CASES[case]
    npz = _load(name)
    model = tsage.GraphSAGENetwork(
        npz["weights/scorer"].shape[0], hid_units=int(npz["meta/hid_units"]),
        num_samples=(0, 0), concat_jk=concat_jk)
    x = _t(npz["inputs/features"])
    model.init(x.shape[1], 1, torch.Generator().manual_seed(0))
    # the reference applies W · concat(self, neigh)^T: ours is W^T
    tsage.load_jax_graphsage_params(model, {
        "W1": npz["weights/enc1"].T, "W2": npz["weights/enc2"].T,
        "Wout": npz["weights/scorer"].T})
    adj = sp.csr_matrix(
        (np.ones(npz["inputs/adj/indices"].size, np.float32),
         npz["inputs/adj/indices"], npz["inputs/adj/indptr"]),
        shape=tuple(npz["inputs/adj/shape"]))
    table, valid = tsage.build_neighbor_table(adj)
    ell = tsage.ELLGraph(table=table, valid=valid, nnz=int(adj.nnz))
    labels = npz["tensors/labels"]
    onehot = _t(np.eye(int(labels.max()) + 1)[labels])
    return npz, model, x, ell, onehot


@pytest.mark.parametrize("case", sorted(SAGE_CASES))
def test_graphsage_forward_matches_reference_torch(case):
    npz, model, x, ell, onehot = _sage_build(case)
    capture = {}
    with torch.no_grad():
        logits = model(ell, x, [], capture=capture)
        loss = model.loss(logits, onehot, _t(npz["tensors/train_mask"]))
        acc = masked_accuracy(logits, onehot, _t(npz["tensors/test_mask"]))
    np.testing.assert_allclose(logits.numpy(), npz["predictions"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(capture["activations/0-enc1"].numpy(),
                               npz["golden/layer1"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), npz["golden/train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(acc), npz["golden/test_acc"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(SAGE_CASES))
def test_graphsage_training_dynamics_match_reference_torch(case):
    """10 full-train-batch SGD steps (lr 0.7, plain CE, no L2)."""
    npz, model, x, ell, onehot = _sage_build(case)
    train_mask = _t(npz["tensors/train_mask"])
    opt = torch.optim.SGD(model.parameters(), lr=float(npz["meta/lr"]))
    losses = []
    for _ in range(len(npz["golden/step_losses"])):
        opt.zero_grad()
        loss = model.loss(model(ell, x, []), onehot, train_mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, npz["golden/step_losses"], rtol=1e-4,
                               atol=1e-5)
    for ours, ref in (("W1", "enc1"), ("W2", "enc2"), ("Wout", "scorer")):
        np.testing.assert_allclose(
            getattr(model, ours).detach().numpy(),
            npz[f"weights_after/{ref}"].T, rtol=1e-3, atol=2e-5,
            err_msg=f"post-training weight {ref}")

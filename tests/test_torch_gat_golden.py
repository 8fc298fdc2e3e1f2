"""The PyTorch port's GAT against the executed reference TF1 SpGAT golden.

tests/golden/ref_gatbase_cora.npz holds Cora's features, the self-looped
support the reference feeds, the reference's initialized weights of all 9
heads, its eval-mode logits, hidden layer, loss terms and accuracy, and the
losses and weights of 10 dropout-free TF1-Adam steps. The reference weights
go into the port's GATNetwork (load_jax_gat_params takes the JAX package's
pytree), and the port must reproduce the golden at the tolerances of
tests/test_golden_gat_baseline.py, through the segment path and through
the fused path (the plain versions of the BSR attention kernels on the
CPU)."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu_torch.models.GAT import GATNetwork, build_gat_adjacency
from h2gcn_tpu_torch.models._runtime import KerasAdam
from h2gcn_tpu_torch.nn import load_jax_gat_params
from h2gcn_tpu_torch.nn.metrics import masked_accuracy, masked_softmax_cross_entropy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "ref_gatbase_cora.npz")
PATHS = ["segment", "fused"]


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip(f"{GOLDEN} not present")
    return np.load(GOLDEN)


def _weight_map(n_heads):
    """((layer, head, key), reference variable, kind) in reference variable
    order: 3 conv1d and 1 BiasAdd per attention head."""
    def conv(i):
        return "conv1d/kernel:0" if i == 0 else f"conv1d_{i}/kernel:0"

    pairs, k = [], 0
    for li, nh in enumerate(n_heads):
        for hi in range(nh):
            pairs += [((li, hi, "W"), conv(3 * k), "kernel"),
                      ((li, hi, "a1"), conv(3 * k + 1), "a"),
                      ((li, hi, "b1"), f"conv1d_{3 * k + 1}/bias:0", "b"),
                      ((li, hi, "a2"), conv(3 * k + 2), "a"),
                      ((li, hi, "b2"), f"conv1d_{3 * k + 2}/bias:0", "b"),
                      ((li, hi, "bias"), "BiasAdd/biases:0" if k == 0
                       else f"BiasAdd_{k}/biases:0", "bias")]
            k += 1
    return pairs


def _ref_weight(npz, prefix, name, kind):
    w = npz[f"{prefix}/{name}"]
    return {"kernel": lambda: w[0], "a": lambda: w[0][:, 0],
            "b": lambda: w[0].reshape(()), "bias": lambda: w}[kind]()


def _build(npz, path):
    hid_units = [int(h) for h in npz["meta/hid_units"]]
    n_heads = [int(h) for h in npz["meta/n_heads"]]
    model = GATNetwork(npz["tensors/y_train"].shape[1], hid_units=hid_units,
                       n_heads=n_heads, in_drop=0.6, attn_drop=0.6,
                       l2_coef=float(npz["meta/l2_coef"]),
                       fused_attention=path == "fused")
    x = torch.from_numpy(npz["inputs/features"])
    model.init(x.shape[1], 1, torch.Generator().manual_seed(0))
    params = {"layers": [[{} for _ in range(nh)] for nh in n_heads]}
    for (li, hi, key), name, kind in _weight_map(n_heads):
        params["layers"][li][hi][key] = _ref_weight(npz, "weights", name, kind)
    load_jax_gat_params(model, params)

    idx = npz["inputs/bias/indices"]
    shape = tuple(int(s) for s in npz["inputs/bias/dense_shape"])
    support = sp.coo_matrix((npz["inputs/bias/values"],
                             (idx[:, 0], idx[:, 1])), shape=shape).tocsr()
    adj = build_gat_adjacency(support, path == "fused")
    assert (adj.bsr is not None) == (path == "fused")
    return model, x, adj, n_heads


def _t(npz, key):
    return torch.from_numpy(np.asarray(npz[key], dtype=np.float32))


@pytest.mark.parametrize("path", PATHS)
def test_forward_matches_reference_tf1(golden, path):
    model, x, adj, _ = _build(golden, path)
    with torch.no_grad():
        logits = model(adj, x, [], training=False)
    np.testing.assert_allclose(logits.numpy(), golden["predictions"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
def test_loss_l2_accuracy_match_reference_tf1(golden, path):
    model, x, adj, _ = _build(golden, path)
    with torch.no_grad():
        logits = model(adj, x, [], training=False)
        l2 = model.l2_loss()
        train_loss = masked_softmax_cross_entropy(
            logits, _t(golden, "tensors/y_train"),
            _t(golden, "tensors/train_mask"))
        acc = masked_accuracy(logits, _t(golden, "tensors/y_test"),
                              _t(golden, "tensors/test_mask"))
    np.testing.assert_allclose(float(l2), golden["golden/l2_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(train_loss), golden["golden/train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(acc), golden["golden/test_acc"], rtol=0,
                               atol=1e-6)


def test_hidden_layer_matches_reference_tf1(golden):
    """Layer 1's 8-head post-ELU concat, captured (capture runs the
    segment path, which also keeps every layer's coefficients)."""
    model, x, adj, n_heads = _build(golden, "fused")
    cap = {}
    with torch.no_grad():
        model(adj, x, [], training=False, capture=cap)
    np.testing.assert_allclose(cap["activations/0-gat"].numpy(),
                               golden["golden/layer1"], rtol=1e-4, atol=1e-5)
    coefs = model.last_attn_coefs
    assert [c.shape[0] for c in coefs] == n_heads
    assert all(c.shape[1] == adj.rows.shape[0] for c in coefs)


@pytest.mark.parametrize("path", PATHS)
def test_training_dynamics_match_reference_tf1(golden, path):
    """From the reference's initialized weights, 10 dropout-free TF1-Adam
    steps (base_gattn.py:20-26: eps 1e-8, on loss + L2) reproduce the
    reference's per-step losses and final weights."""
    model, x, adj, n_heads = _build(golden, path)
    y = _t(golden, "tensors/y_train")
    mask = _t(golden, "tensors/train_mask")
    opt = KerasAdam(model.parameters(), float(golden["meta/lr"]), eps=1e-8)
    losses = []
    for _ in range(len(golden["golden/step_losses"])):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(model(adj, x, [], training=False), y, mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, golden["golden/step_losses"],
                               rtol=1e-4, atol=1e-5)
    for (li, hi, key), name, kind in _weight_map(n_heads):
        ref = _ref_weight(golden, "weights_after", name, kind)
        np.testing.assert_allclose(
            model.layers[li][hi][key].detach().numpy(), ref, rtol=1e-3,
            atol=2e-5, err_msg=f"post-training weight {name} diverges")

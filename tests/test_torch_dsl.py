"""The layer DSL's remaining kinds in the PyTorch port against the JAX
package: identity, slice, stop-gradient, lambda and experimental (X)
layers, the E and L modifiers, return_before / execute_after (negative
indices too), add_supervision, get_embeddings and call_output_network,
the capture names, and every function of the lambda namespace.

The same numpy-made graph, features and (through load_jax_params) weights
go through both packages. Forwards agree at rtol 1e-5 (atol 1e-6);
dropout-free train steps through both runtimes at rtol 2e-5 (atol 2e-6),
the tolerance of test_torch_slice.py."""

from argparse import Namespace
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from h2gcn_tpu.models import _runtime as j_runtime
from h2gcn_tpu.nn import NetworkModel as JNetworkModel
from h2gcn_tpu.nn import parse_network_setup as j_parse
from h2gcn_tpu.nn.model import experimental_registry as j_registry
from h2gcn_tpu.sparse import SparseMatrix as JSparseMatrix
from h2gcn_tpu_torch.models import _runtime as t_runtime
from h2gcn_tpu_torch.nn import (NetworkModel, _lambda_ns, load_jax_params,
                                parse_network_setup)
from h2gcn_tpu_torch.nn.model import experimental_registry
from h2gcn_tpu_torch.sparse import SparseMatrix

N, F, C = 40, 12, 3
RTOL, ATOL = 1e-5, 1e-6


def _scale_factory(conf, output_dim):
    factor = float(conf)

    def fn(params, adj, x, adjhops, tagged):
        return x * factor

    return fn


@pytest.fixture(autouse=True)
def scale_layer():
    """The X layer ``scale`` in both packages' registries."""
    j_registry["scale"] = experimental_registry["scale"] = _scale_factory
    yield
    del j_registry["scale"], experimental_registry["scale"]


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    a = sp.random(N, N, density=0.15, random_state=1, format="csr",
                  dtype=np.float32)
    a = ((a + a.T) > 0).astype(np.float32)
    hops = [sp.csr_matrix(a.multiply(rng.random(a.shape)).astype(np.float32))
            for _ in range(2)]
    feats = rng.random((N, F)).astype(np.float32)
    return a, hops, feats


def _pair(graph, setup, sparse_x=False):
    """The JAX and port models of ``setup`` with the same weights, and
    their inputs ``(adj, x, hops)``."""
    a, hops, feats = graph
    jm = JNetworkModel(j_parse(setup, C, _dense_units=8, _dropout_rate=0.5),
                       l2_regularize_weight=5e-4)
    params = jm.init(jax.random.PRNGKey(3), F, len(hops))
    tm = NetworkModel(parse_network_setup(setup, C, _dense_units=8,
                                          _dropout_rate=0.5),
                      l2_regularize_weight=5e-4)
    tm.init(F, len(hops), torch.Generator().manual_seed(0))
    load_jax_params(tm, [{k: np.asarray(v) for k, v in p.items()}
                         for p in params])
    j_in = (JSparseMatrix.from_scipy(a, backend="segment"),
            (JSparseMatrix.from_scipy(sp.csr_matrix(feats), backend="segment")
             if sparse_x else jnp.asarray(feats)),
            [JSparseMatrix.from_scipy(h, backend="segment") for h in hops])
    t_in = (SparseMatrix.from_scipy(a, backend="segment"),
            (SparseMatrix.from_scipy(sp.csr_matrix(feats), backend="segment")
             if sparse_x else torch.from_numpy(feats)),
            [SparseMatrix.from_scipy(h, backend="segment") for h in hops])
    return jm, params, j_in, tm, t_in


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


SETUPS = {
    "identity": "I-M8-R-MO",
    "slice_tag": "M8-R-T1-G-V-S1_2_6-MO",
    "slice_input": "M8-R-S_1_7-MO",
    "lambda": "M8-[lambda x: nn.gelu(jnp.tanh(x) * 2)]-MO",
    "stop_gradient": "M8-SG-MO",
    "experimental": "M8-Xscale_2.5-MO",
    "modifiers": "M8-E-R-T1-G-V-T2-G-V-C1-C2-L-MO",
    "all_kinds": ("I-M16-E-R-T1-G-V-T2-G-V-C1-C2-[lambda x: jnp.tanh(x)]-SG-"
                  "S_0_24-Xscale_2-L-FO"),
}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_forward_and_capture_match_jax(graph, name):
    sparse_x = SETUPS[name].startswith("I-")
    jm, params, j_in, tm, t_in = _pair(graph, SETUPS[name], sparse_x)
    j_cap, t_cap = {}, {}
    ref = jm.apply(params, *j_in, capture=j_cap)
    got = tm(*t_in, capture=t_cap)
    _close(got, ref)
    assert tm.names == jm.names
    assert sorted(t_cap) == sorted(j_cap)
    for key, value in j_cap.items():
        if key == "inputs/inputs":
            continue  # the input itself (a SparseMatrix for "I-...")
        _close(t_cap[key], value)


def test_routing_matches_jax(graph):
    """return_before and execute_after (negative indices too),
    add_supervision's outputs, get_embeddings and call_output_network."""
    setup = "M8-E-R-T1-G-V-T2-G-V-C1-C2-L-D0.5-MO"
    jm, params, j_in, tm, t_in = _pair(graph, setup)
    assert (tm.embedding_ind, tm.output_ind, tm.supervised_inds) == (
        jm.embedding_ind, jm.output_ind, jm.supervised_inds) == (0, 9, {7})
    for rb in (1, 3, 7, -1, -4, 0):
        _close(tm(*t_in, return_before=rb),
               jm.apply(params, *j_in, return_before=rb))
    # execute_after feeds x to the layer it names: the JAX package's rule
    hidden_j = jm.apply(params, *j_in, return_before=8)
    hidden_t = tm(*t_in, return_before=8)
    for ea in (7, 8, 9, -1, -2, -3):
        _close(tm(t_in[0], hidden_t, t_in[2], execute_after=ea),
               jm.apply(params, j_in[0], hidden_j, j_in[2], execute_after=ea))
    out_t, sup_t = tm(*t_in, add_supervision=True)
    out_j, sup_j = jm.apply(params, *j_in, add_supervision=True)
    _close(out_t, out_j)
    assert len(sup_t) == len(sup_j) == 1
    _close(sup_t[0], sup_j[0])
    _close(tm.get_embeddings(*t_in), jm.get_embeddings(params, *j_in))
    _close(tm.call_output_network(t_in[0], hidden_t, t_in[2]),
           jm.call_output_network(params, j_in[0], hidden_j, j_in[2]))
    with pytest.raises(AssertionError, match="E-marked"):
        _pair(graph, "M8-MO")[3].get_embeddings(*t_in)


def test_load_jax_params_maps_by_layer_index(graph):
    """Layers without parameters (slice, lambda, X, SG, I) keep the JAX
    list's indices: each kernel lands on its own layer."""
    jm, params, _, tm, _ = _pair(graph, SETUPS["all_kinds"], sparse_x=True)
    keys = {f"kernels.{i}" for i, p in enumerate(params) if "kernel" in p}
    assert keys == {k for k in tm.state_dict() if k.startswith("kernels.")}
    assert keys == {"kernels.1", "kernels.13"}
    for i, p in enumerate(params):
        if "kernel" in p:
            _close(tm.kernels[str(i)], p["kernel"], 0, 0)
    assert "13" in tm.biases and len(tm.biases) == 1


def test_experimental_layer_registry(graph):
    """The port's copy of the JAX package's X-layer test: an X layer
    scales its input and owns no parameters."""
    _, hops, _ = graph
    adj = SparseMatrix.from_scipy(sp.eye(10, format="csr", dtype=np.float32),
                                  backend="segment")
    model = NetworkModel(parse_network_setup("M8-Xscale_2.5-MO", 3,
                                             _dense_units=8))
    model.init(6, 1, torch.Generator().manual_seed(0))
    assert model.names[1] == "x_scale"
    plain = NetworkModel(parse_network_setup("M8-MO", 3, _dense_units=8))
    plain.init(6, 1, torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain.kernels["0"].copy_(model.kernels["0"])
        plain.kernels["1"].copy_(model.kernels["2"])
    x = torch.ones(10, 6)
    out = model(adj, x, [adj])
    torch.testing.assert_close(out, 2.5 * plain(adj, x, [adj]), rtol=1e-5,
                               atol=0)
    with pytest.raises(KeyError):
        NetworkModel(parse_network_setup("M8-Xnone_1-MO", 3, _dense_units=8))


def test_stop_gradient_blocks_the_gradient(graph):
    _, _, _, tm, t_in = _pair(graph, "M8-SG-MO")
    torch.sum(tm(*t_in) ** 2).backward()
    assert tm.kernels["0"].grad is None  # blocked: no gradient at all
    assert tm.kernels["2"].grad is not None
    assert float(tm.kernels["2"].grad.abs().max()) > 0


def _args(tensors, n_labels):
    ds = Namespace(feature_dim=F, num_labels=n_labels)
    return Namespace(
        objects={"dataset": ds, "tensors": tensors,
                 "post_epoch_callbacks": deque(),
                 "post_train_callbacks": deque()},
        random_seed=123, grad_monitor=False, verbose=False, use_signac=False,
        deg_acc_monitor=[], best_val_criteria="val_acc", current_epoch=0)


def _split(n, seed=5):
    rng = np.random.default_rng(seed)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, n)]
    masks = [np.zeros(n, np.float32) for _ in range(3)]
    order = rng.permutation(n)
    for m, part in zip(masks, np.array_split(order, 3)):
        m[part] = 1
    out = {}
    for scope, m in zip(("train", "val", "test"), masks):
        out[f"y_{scope}"] = labels * m[:, None]
        out[f"{scope}_mask"] = m
    return out


@pytest.mark.parametrize("setup", [
    # every new kind trains: the dense layers before SG-free routing
    "M16-E-R-T1-G-V-T2-G-V-C1-C2-[lambda x: jnp.tanh(x)]-S_0_40-Xscale_2-MO",
    # a layer whose output nothing reads: its bias gets no gradient in
    # the port (grad None, KerasAdam skips it and keeps no count), a zero
    # one in JAX (the shared count advances, the update is 0/(0+eps) = 0)
    "F8-T1-F4-S1-FO",
])
def test_train_steps_match_jax_runtime(graph, setup):
    """Five dropout-free keras-Adam steps through both runtimes from the
    same weights; the port's per-tensor step counts against JAX's shared
    one where a kernel gets no gradient."""
    a, hops, feats = graph
    split = _split(N)
    j_t = dict(adj=JSparseMatrix.from_scipy(a, backend="segment"),
               adj_hops=[JSparseMatrix.from_scipy(h, backend="segment")
                         for h in hops], features=jnp.asarray(feats),
               **{k: jnp.asarray(v) for k, v in split.items()})
    t_t = dict(adj=SparseMatrix.from_scipy(a, backend="segment"),
               adj_hops=[SparseMatrix.from_scipy(h, backend="segment")
                         for h in hops], features=torch.from_numpy(feats),
               **{k: torch.from_numpy(v) for k, v in split.items()})
    jargs, targs = _args(j_t, C), _args(t_t, C)
    j_runtime.initialize_model(jargs, JNetworkModel(
        j_parse(setup, C), l2_regularize_weight=5e-4), "adam", 0.01, 0)
    model = NetworkModel(parse_network_setup(setup, C),
                         l2_regularize_weight=5e-4)
    t_runtime.initialize_model(targs, model, "adam", 0.01, 0)
    load_jax_params(model, [{k: np.asarray(v) for k, v in p.items()}
                            for p in jargs.objects["state"]["params"]])
    j_losses, t_losses = [], []
    for epoch in range(1, 6):
        jargs.current_epoch = targs.current_epoch = epoch
        j_losses.append(float(jargs.objects["train_step"](**j_t)["train_loss"]))
        t_losses.append(float(targs.objects["train_step"](**t_t)["train_loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-5, atol=2e-6)
    j_stats = jargs.objects["test_step"](**j_t)
    t_stats = targs.objects["test_step"](**t_t)
    for key in ("val_loss", "test_loss", "train_acc", "val_acc",
                "test_accuracy"):
        np.testing.assert_allclose(float(t_stats[key]), float(j_stats[key]),
                                   rtol=2e-5, atol=2e-6, err_msg=key)
    counts = {n: targs.objects["optimizer"].state[p].get("count")
              for n, p in model.named_parameters()}
    if setup.startswith("F8-T1"):
        # the dropped layer's bias never had a gradient in the port and
        # kept no count; in both packages it is still its initial zero
        assert counts.pop("biases.1") is None
        assert not model.biases["1"].detach().any()
        assert not np.asarray(jargs.objects["state"]["params"][1]["bias"]).any()
    assert set(counts.values()) == {5}


# ------------------------------------------------------- the lambda namespace
LAMBDA_CASES = [
    "jnp.abs(x)", "jnp.exp(x)", "jnp.log(y)", "jnp.log1p(y)", "jnp.expm1(x)",
    "jnp.sqrt(y)", "jnp.square(x)", "jnp.tanh(x)", "jnp.sin(x)", "jnp.cos(x)",
    "jnp.sign(x)", "jnp.floor(x * 3)", "jnp.ceil(x * 3)", "jnp.negative(x)",
    "jnp.maximum(x, 0.1)", "jnp.maximum(x, x * x)", "jnp.minimum(x, -0.2)",
    "jnp.power(y, 1.5)", "jnp.power(y, x)", "jnp.where(x > 0, x, 0.5)",
    "jnp.where(x > 0, x, y)", "jnp.clip(x, -0.5, 0.5)", "jnp.clip(x, 0.0)",
    "jnp.sum(x)", "jnp.sum(x, axis=1)", "jnp.sum(x, axis=0, keepdims=True)",
    "jnp.mean(x)", "jnp.mean(x, axis=1, keepdims=True)", "jnp.max(x)",
    "jnp.max(x, axis=1)", "jnp.min(x, axis=0)", "jnp.min(x, keepdims=True)",
    "jnp.concatenate([x, y], axis=1)", "jnp.concatenate((x, y))",
    "jnp.stack([x, y], axis=1)", "jnp.stack([x, y])",
    "jnp.reshape(x, (-1, 4))", "jnp.matmul(x, y.T)",
    "nn.relu(x)", "nn.relu6(x * 8)", "nn.elu(x)", "nn.elu(x, alpha=0.5)",
    "nn.celu(x)", "nn.celu(x, 0.7)", "nn.selu(x)", "nn.leaky_relu(x)",
    "nn.leaky_relu(x, negative_slope=0.2)", "nn.gelu(x)",
    "nn.gelu(x, approximate=False)", "nn.sigmoid(x)", "nn.log_sigmoid(x)",
    "nn.softplus(x * 30)", "nn.silu(x)", "nn.swish(x)", "nn.mish(x)",
    "nn.soft_sign(x)", "nn.hard_tanh(x * 3)", "nn.tanh(x)", "nn.softmax(x)",
    "nn.softmax(x, axis=0)", "nn.log_softmax(x)",
    "nn.log_softmax(x, axis=0)",
]


@pytest.mark.parametrize("expr", LAMBDA_CASES)
def test_lambda_namespace_matches_jax(expr):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((6, 8)) * 1.5).astype(np.float32)
    y = (rng.random((6, 8)) + 0.1).astype(np.float32)
    fn = f"lambda x, y: {expr}"
    ref = eval(fn, {"__builtins__": {}, "jnp": jnp, "nn": jax.nn})(
        jnp.asarray(x), jnp.asarray(y))
    got = eval(fn, {"__builtins__": {}, "jnp": _lambda_ns.jnp,
                    "nn": _lambda_ns.nn})(torch.from_numpy(x),
                                          torch.from_numpy(y))
    assert tuple(got.shape) == tuple(np.shape(ref))
    _close(got, ref)


def test_lambda_namespace_is_covered_and_closed():
    """Every mapped function has a case above; a name outside the list,
    and any builtin, raises."""
    for ns_name in ("jnp", "nn"):
        for fn in vars(getattr(_lambda_ns, ns_name)):
            assert any(case.startswith(f"{ns_name}.{fn}(")
                       for case in LAMBDA_CASES), f"{ns_name}.{fn}"
    with pytest.raises(AttributeError):
        _lambda_ns.jnp.einsum
    with pytest.raises(AttributeError):
        _lambda_ns.nn.one_hot
    model = NetworkModel(parse_network_setup(
        "[lambda x: abs(x)]-MO", 3))
    with pytest.raises(NameError):
        model.layer_setups[0][1]["fn"](torch.ones(2))

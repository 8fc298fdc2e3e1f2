"""The distributed layer (h2gcn_tpu_torch.parallel) across real gloo ranks.

One spawn of two ranks (and one of four, for the ring and halo modes and
GAT's padding) runs every check of ``torch_dist_worker.parity`` and hands
back rank 0's report; the tests hold it against scipy, the port on one
device, and the JAX package's ``build_dist_steps`` on its 8-device CPU
mesh. Tolerances are the JAX package's own (tests/test_parallel.py):
SpMM rtol = atol = 1e-5, the loss rtol 1e-4, parameters and gradients
rtol 1e-4 / atol 1e-5; dropout-free, as there (a rank's dropout draws
from its own generator). The distributed steps train with SGD 0.5: a big
step exposes gradient errors.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_worker as worker
from h2gcn_tpu.models.GAT import GATNetwork as JGAT
from h2gcn_tpu.nn import NetworkModel as JNetworkModel
from h2gcn_tpu.nn import parse_network_setup as j_parse
from h2gcn_tpu.parallel import attention as j_attn
from h2gcn_tpu.parallel import dist as j_dist
from h2gcn_tpu.parallel import train as j_train
from h2gcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from h2gcn_tpu.sparse import transforms as j_transforms
from h2gcn_tpu_torch.models.GAT import GATNetwork, build_gat_adjacency
from h2gcn_tpu_torch.nn import load_jax_gat_params, load_jax_params
from h2gcn_tpu_torch.parallel.mesh import spawn
from h2gcn_tpu_torch.sparse import SparseMatrix

MODES = worker.MODES
RTOL, ATOL = 1e-4, 1e-5


def _tree(a):
    """JAX parameters as numpy, for the ranks."""
    return jax.tree_util.tree_map(np.asarray, a)


@pytest.fixture(scope="module")
def problem():
    """test_parallel.py's problem (120 nodes, Â₁ and Â₂, 24 features, 5
    classes), GAT's self-looped support, a cotangent for the SpMMs'
    backward, and the JAX package's parameters of every model here."""
    rng = np.random.default_rng(0)
    n, f, c = 120, 24, 5
    A = sp.random(n, n, density=0.06, random_state=1, format="csr")
    A = ((A + A.T) > 0).astype(np.float32)
    A = j_transforms.remove_eye(A)
    hops = j_transforms.nhood_split(A, 2)
    mats = [j_transforms.normalize(hops[1]), j_transforms.normalize(hops[2])]
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = np.zeros((n, c), np.float32)
    y[np.arange(n), rng.integers(0, c, n)] = 1
    mask = rng.random(n) < 0.4
    split = rng.random(n)
    p = dict(n=n, f=f, c=c, mats=mats, x=x, y=y, mask=mask,
             train_mask=split < 0.3, val_mask=(split >= 0.3) & (split < 0.6),
             support=((A + sp.eye(n)) > 0).astype(np.float32),
             g=rng.standard_normal((n, f)).astype(np.float32))
    p["eval_model"] = JNetworkModel(j_parse(
        worker.EVAL_SETUP, c, _dense_units=16, _dropout_rate=0.5),
        l2_regularize_weight=5e-4)
    p["train_model"] = JNetworkModel(j_parse(
        worker.TRAIN_SETUP, c, _dense_units=16), l2_regularize_weight=5e-4)
    p["eval_params"] = p["eval_model"].init(jax.random.PRNGKey(0), f, 2)
    p["train_params"] = p["train_model"].init(jax.random.PRNGKey(1), f, 2)
    gat_kw = dict(hid_units=[8], n_heads=[2, 1], in_drop=0.0, attn_drop=0.0,
                  fused_attention=True)
    p["gat_model"] = JGAT(c, **gat_kw)
    p["gat_params"] = p["gat_model"].init(jax.random.PRNGKey(0), f)
    p["gat_res_model"] = JGAT(c, residual=True, **gat_kw)
    p["gat_res_params"] = p["gat_res_model"].init(jax.random.PRNGKey(2), f)
    return p


def _rank_data(p, tmp_path, **extra):
    keys = ("n", "f", "c", "mats", "x", "y", "mask", "train_mask",
            "val_mask", "support", "g")
    data = {k: p[k] for k in keys}
    for k in ("eval_params", "train_params", "gat_params", "gat_res_params"):
        data[k] = _tree(p[k])
    data.update(extra)
    path = os.path.join(tmp_path, "problem.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


@pytest.fixture(scope="module")
def report(problem, tmp_path_factory):
    """Rank 0's report of the two-rank world."""
    path = _rank_data(problem, tmp_path_factory.mktemp("dist2"))
    return spawn(worker.parity, 2, "cpu", path)


@pytest.fixture(scope="module")
def report4(problem, tmp_path_factory):
    """Rank 0's report of a four-rank world: ring and halo, and GAT."""
    path = _rank_data(problem, tmp_path_factory.mktemp("dist4"),
                      modes=("ring", "halo"))
    return spawn(worker.parity, 4, "cpu", path, ("spmm", "train", "gat"))


# ---------------------------------------------------------------- references
def _t_model(p, which):
    model = worker._net(worker.EVAL_SETUP if which == "eval"
                        else worker.TRAIN_SETUP, p["c"])
    model.init(p["f"], 2, torch.Generator().manual_seed(0))
    return load_jax_params(model, _tree(p[f"{which}_params"]))


def _hops(p):
    return [SparseMatrix.from_scipy(m, backend="segment") for m in p["mats"]]


@pytest.fixture(scope="module")
def single(problem):
    """The port's one-device eval and SGD step from the same parameters."""
    p = problem
    ah = _hops(p)
    x, y = torch.from_numpy(p["x"]), torch.from_numpy(p["y"])
    mask = torch.from_numpy(p["mask"])
    model = _t_model(p, "eval")
    with torch.no_grad():
        logits = model(ah[0], x, ah)
    from h2gcn_tpu_torch.nn import masked_accuracy, masked_softmax_cross_entropy

    out = dict(eval=dict(acc=float(masked_accuracy(logits, y, mask)),
                         loss=float(masked_softmax_cross_entropy(
                             logits, y, mask))))
    model = _t_model(p, "train")
    loss = model.loss(model(ah[0], x, ah), y, mask)
    loss.backward()
    out["train"] = dict(loss=float(loss.detach()), grads={
        k: q.grad.numpy().copy() for k, q in model.named_parameters()})
    with torch.no_grad():
        out["train"]["params"] = {k: (q - 0.5 * q.grad).numpy()
                                  for k, q in model.named_parameters()}
    return out


def _j_put(mesh, a, n_pad):
    return jax.device_put(jnp.asarray(j_dist.pad_nodes(a, n_pad)),
                          NamedSharding(mesh, P("graph")))


@pytest.fixture(scope="module")
def jax_steps(problem):
    """The JAX package's build_dist_steps on its 8-device CPU mesh: eval
    (allgather) and one SGD 0.5 step in every mode, and GAT's step."""
    p = problem
    mesh = j_make_mesh(8)
    tx = optax.sgd(0.5)
    out = {}
    for mode in MODES:
        shards, n_pad = j_dist.shard_hops(p["mats"], 8, mode=mode)
        xd, yd, md = (_j_put(mesh, p[k], n_pad) for k in ("x", "y", "mask"))
        if mode == "allgather":
            _, eval_step = j_train.build_dist_steps(p["eval_model"], tx, mesh,
                                                    shards)
            ev = eval_step(p["eval_params"], xd, yd, md)
            out["eval"] = {k: float(v) for k, v in ev.items()}
        train_step, _ = j_train.build_dist_steps(p["train_model"], tx, mesh,
                                                 shards)
        params, _, loss = train_step(p["train_params"],
                                     tx.init(p["train_params"]),
                                     jax.random.PRNGKey(1), xd, yd, md)
        out[mode] = dict(loss=float(loss), params=_tree(params))
    dga, n_pad = j_attn.shard_attention_gather(p["support"], 8)
    dm = j_attn.DistGATNetwork.from_single(p["gat_model"])
    train_step, _ = j_train.build_dist_steps(dm, tx, mesh, [dga])
    xd, yd, md = (_j_put(mesh, p[k], n_pad) for k in ("x", "y", "mask"))
    out["gat_logits"] = np.asarray(
        train_step.logits(p["gat_params"], xd))[:p["n"]]
    params, _, loss = train_step(p["gat_params"], tx.init(p["gat_params"]),
                                 jax.random.PRNGKey(1), xd, yd, md)
    out["gat"] = dict(loss=float(loss), params=_tree(params))
    return out


def _port_gat(p, key="gat_params", **kw):
    kw = dict(dict(hid_units=[8], n_heads=[2, 1], in_drop=0.0,
                   attn_drop=0.0, fused_attention=True), **kw)
    model = GATNetwork(p["c"], **kw)
    model.init(p["f"], 1, torch.Generator().manual_seed(0))
    return load_jax_gat_params(model, _tree(p[key]))


def _gat_adj(p):
    return build_gat_adjacency(p["support"], fused_attention=True,
                               attn_impl="gather")


def _close_params(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _jax_params_by_name(jparams, tparams_names):
    """The JAX NetworkModel's parameter list under the port's names."""
    out = {}
    for ind, layer in enumerate(jparams):
        if isinstance(layer, dict):
            for name, store in (("kernel", "kernels"), ("bias", "biases")):
                if name in layer:
                    out[f"{store}.{ind}"] = np.asarray(layer[name])
    assert set(out) == set(tparams_names)
    return out


def _jax_gat_by_name(jparams):
    return {f"layers.{li}.{hi}.{k}": np.asarray(v)
            for li, heads in enumerate(jparams["layers"])
            for hi, head in enumerate(heads) for k, v in head.items()}


# --------------------------------------------------------------------- SpMM
@pytest.mark.parametrize("mode", MODES)
def test_spmm_matches_scipy(report, problem, mode):
    for i, m in enumerate(problem["mats"]):
        np.testing.assert_allclose(report[f"spmm/{mode}/{i}"],
                                   m @ problem["x"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_spmm_backward_matches_scipy(report, problem, mode):
    """The collectives' backwards route Aᵀg to the owning rank."""
    for i, m in enumerate(problem["mats"]):
        np.testing.assert_allclose(report[f"spmm_grad/{mode}/{i}"],
                                   m.T @ problem["g"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["ring", "halo"])
def test_four_ranks_spmm_matches_scipy(report4, problem, mode):
    assert report4["world"] == 4
    for i, m in enumerate(problem["mats"]):
        np.testing.assert_allclose(report4[f"spmm/{mode}/{i}"],
                                   m @ problem["x"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(report4[f"spmm_grad/{mode}/{i}"],
                                   m.T @ problem["g"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["halo", "halo-cootile"])
def test_halo_interior_reduce_runs_while_the_exchange_travels(report, mode):
    """The all_to_all is issued, the interior reduce runs, and only then
    does the rank wait for the exchange and reduce the halo edges."""
    assert report["order"][mode] == ["issue", "interior", "wait", "halo"]


@pytest.mark.parametrize("mode", MODES)
def test_world_of_one_spmm_matches_scipy(problem, tmp_path, monkeypatch,
                                         mode):
    """At world size 1 every edge is interior: the halo modes issue no
    exchange and reduce no halo (one local reduce a SpMM), and every
    mode's A x and Aᵀg match scipy."""
    import torch.distributed as tdist

    from h2gcn_tpu_torch.nn.model import _aggregate
    from h2gcn_tpu_torch.parallel import _collectives
    from h2gcn_tpu_torch.parallel import dist as pdist
    from h2gcn_tpu_torch.parallel.mesh import init_group

    reduces = []
    spmm, segment = pdist.spmm, pdist._segment

    def count(fn):
        def counted(*a, **kw):
            reduces.append(fn)
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(pdist, "spmm", count(spmm))
    monkeypatch.setattr(pdist, "_segment", count(segment))
    if mode.startswith("halo"):
        def never(*a, **kw):
            raise AssertionError("a world of one exchanged its halo")

        monkeypatch.setattr(_collectives, "all_to_all_start", never)
    mesh = init_group(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu")
    try:
        shards, n_pad = pdist.shard_hops(problem["mats"], 1, mode=mode)
        n = problem["n"]
        for m, shard in zip(problem["mats"], shards):
            x = torch.from_numpy(pdist.pad_nodes(problem["x"], n_pad)
                                 ).requires_grad_(True)
            del reduces[:]
            y = _aggregate(shard.local(mesh), x)
            if mode.startswith("halo"):
                assert len(reduces) == 1
            y.backward(torch.from_numpy(pdist.pad_nodes(problem["g"],
                                                        n_pad)))
            np.testing.assert_allclose(y.detach().numpy()[:n],
                                       m @ problem["x"], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(x.grad.numpy()[:n],
                                       m.T @ problem["g"], rtol=1e-5,
                                       atol=1e-5)
    finally:
        tdist.destroy_process_group()


# ------------------------------------------------------------ train and eval
@pytest.mark.parametrize("mode", MODES)
def test_eval_matches_single_device_and_jax(report, single, jax_steps, mode):
    got = report[f"eval/{mode}"]
    for ref in (single["eval"], jax_steps["eval"]):
        np.testing.assert_allclose(got["acc"], ref["acc"], atol=1e-5)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_single_device(report, single, mode):
    got, ref = report[f"train/{mode}"], single["train"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
    _close_params(got["grads"], ref["grads"])
    _close_params(got["params"], ref["params"])


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(report, jax_steps, mode):
    got, ref = report[f"train/{mode}"], jax_steps[mode]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
    _close_params(got["params"],
                  _jax_params_by_name(ref["params"], got["params"]))


@pytest.mark.parametrize("mode", ["ring", "halo"])
def test_four_ranks_train_step_matches_single_device(report4, single, mode):
    got, ref = report4[f"train/{mode}"], single["train"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
    _close_params(got["grads"], ref["grads"])
    _close_params(got["params"], ref["params"])


def test_parameters_stay_bitwise_equal_on_every_rank(report):
    """Three KerasAdam steps with each rank's own dropout draws."""
    params = report["replicas/params"]
    assert params.shape[0] == 2
    np.testing.assert_array_equal(params[0], params[1])


def test_keras_adam_counts_are_equal_on_every_rank(report):
    counts = report["replicas/counts"]
    np.testing.assert_array_equal(counts[0], counts[1])
    assert np.all(counts == 3)


def test_block_matches_per_epoch_steps(report):
    """``.block`` runs the per-epoch steps with one readback."""
    epochs, block = report["block"]["epochs"], report["block"]["block"]
    for key, ref in epochs["table"].items():
        np.testing.assert_allclose(block["table"][key], ref, rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    best = int(np.flatnonzero(
        epochs["table"]["val_acc"] == epochs["table"]["val_acc"].max())[-1])
    assert block["table"]["val_acc"][best] == max(block["table"]["val_acc"])
    assert set(block["best"]) == set(report["train/ring"]["params"])


def test_dryrun_runs_every_mode(report):
    losses = report["dryrun"]
    assert set(losses) == set(MODES) | {"gat"}
    assert all(np.isfinite(v) for v in losses.values())
    # the four halo modes compute one function
    np.testing.assert_allclose([losses[m] for m in MODES],
                               losses["ring"], rtol=1e-5)


# ----------------------------------------------------------------------- GAT
def test_gat_logits_match_single_device_and_jax(report, problem, jax_steps):
    p = problem
    with torch.no_grad():
        ref = _port_gat(p)(_gat_adj(p), torch.from_numpy(p["x"])).numpy()
    np.testing.assert_allclose(report["gat/logits"], ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(report["gat/logits"], jax_steps["gat_logits"],
                               rtol=1e-5, atol=1e-5)


def test_gat_train_step_matches_single_device_and_jax(report, problem,
                                                      jax_steps):
    p = problem
    model = _port_gat(p)
    y, mask = torch.from_numpy(p["y"]), torch.from_numpy(p["mask"])
    loss = model.loss(model(_gat_adj(p), torch.from_numpy(p["x"]),
                            training=True), y, mask)
    loss.backward()
    got = report["gat/train"]
    np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=RTOL)
    np.testing.assert_allclose(got["loss"], jax_steps["gat"]["loss"],
                               rtol=RTOL)
    _close_params(got["grads"], {k: q.grad.numpy()
                                 for k, q in model.named_parameters()})
    _close_params(got["params"], _jax_gat_by_name(jax_steps["gat"]["params"]))


def test_gat_residual_matches_single_device(report, problem):
    p = problem
    model = _port_gat(p, "gat_res_params", residual=True)
    assert any("Wres" in head for layer in model.layers for head in layer)
    with torch.no_grad():
        ref = model(_gat_adj(p), torch.from_numpy(p["x"])).numpy()
    np.testing.assert_allclose(report["gat/residual_logits"], ref,
                               rtol=1e-5, atol=1e-5)


def test_gat_dropout_trains(report):
    """Input and attention-coefficient dropout on each rank's generator:
    finite losses, and the training loss of the last 3 of 10 Adam steps
    below that of the first 3."""
    d = report["gat/dropout"]
    losses = d["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert np.isfinite(d["after"]) and 0.0 <= d["acc"] <= 1.0 + 1e-5


def test_gat_padding_edges_are_inert(report, report4):
    """Two and four shards pad their edge lists differently; both give the
    one-device logits."""
    assert report4["world"] == 4
    np.testing.assert_allclose(report4["gat/logits"], report["gat/logits"],
                               rtol=1e-5, atol=1e-5)
    _close_params(report4["gat/train"]["params"],
                  report["gat/train"]["params"])

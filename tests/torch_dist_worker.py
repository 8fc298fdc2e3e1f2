"""Rank-side checks of the distributed layer's tests (test_torch_dist.py,
test_torch_dist_cli.py): functions every rank of a spawned gloo world runs
(``h2gcn_tpu_torch.parallel.mesh.spawn``); rank 0's return value is the
report the tests assert on. Imports no JAX, so the ranks start fast."""

import pickle

import numpy as np
import torch

from h2gcn_tpu_torch.models.GAT import GATNetwork
from h2gcn_tpu_torch.models._runtime import KerasAdam
from h2gcn_tpu_torch.nn import (NetworkModel, load_jax_gat_params,
                                load_jax_params, parse_network_setup)
from h2gcn_tpu_torch.nn.model import _aggregate
from h2gcn_tpu_torch.parallel import _collectives
from h2gcn_tpu_torch.parallel import attention as pattn
from h2gcn_tpu_torch.parallel import dist as pdist
from h2gcn_tpu_torch.parallel import dryrun
from h2gcn_tpu_torch.parallel import train as ptrain
from h2gcn_tpu_torch.parallel.mesh import make_mesh

MODES = ("allgather", "ring", "halo", "halo-cootile")
EVAL_SETUP = "M16-R-T1-G-V-T2-G-V-C1-C2-D0.5-MO"
TRAIN_SETUP = "M16-R-T1-G-V-T2-G-V-C1-C2-MO"


def _net(setup, c):
    return NetworkModel(parse_network_setup(setup, c, _dense_units=16,
                                            _dropout_rate=0.5),
                        l2_regularize_weight=5e-4)


def _named(model, what):
    return {k: (p.grad if what == "grad" else p).detach().clone().numpy()
            for k, p in model.named_parameters()}


class _Rows:
    """This rank's rows of the problem's node arrays."""

    def __init__(self, mesh, n_pad):
        self.rows = ptrain.node_slice(mesh, n_pad)
        self.n_pad = n_pad

    def __call__(self, a):
        a = pdist.pad_nodes(np.asarray(a, np.float32), self.n_pad)
        return torch.from_numpy(np.ascontiguousarray(a[self.rows]))


def _spmm_checks(mesh, p, modes, rep):
    """Each mode's forward on both hop matrices and its Aᵀg for the
    problem's cotangent, gathered to every rank."""
    for mode in modes:
        for i, m in enumerate(p["mats"]):
            (sh,), n_pad = pdist.shard_hops([m], mesh.size, mode=mode)
            put = _Rows(mesh, n_pad)
            x = put(p["x"]).requires_grad_()
            out = _aggregate(sh.local(mesh), x)
            out.backward(put(p["g"]))
            n = p["n"]
            rep[f"spmm/{mode}/{i}"] = _collectives.gather_rows(
                out, mesh)[:n].numpy()
            rep[f"spmm_grad/{mode}/{i}"] = _collectives.gather_rows(
                x.grad, mesh)[:n].numpy()


def _halo_order(mesh, p):
    """The order the halo modes issue their work in, recorded by wrapping
    the exchange, its wait and the local reduces."""
    events = []
    start, wait = _collectives.all_to_all_start, _collectives.Pending.wait
    segment, spmm = pdist._segment, pdist.spmm
    orders = {}
    for mode in ("halo", "halo-cootile"):
        (sh,), n_pad = pdist.shard_hops([p["mats"][1]], mesh.size, mode=mode)
        local = sh.local(mesh)
        interior = (local.rows_int if mode == "halo" else local.interior)

        def rec_start(*a, **kw):
            events.append("issue")
            return start(*a, **kw)

        def rec_wait(self):
            events.append("wait")
            return wait(self)

        def rec_segment(rows, *a):
            events.append("interior" if rows is interior else "halo")
            return segment(rows, *a)

        def rec_spmm(a, x):
            events.append("interior" if a is interior else "halo")
            return spmm(a, x)

        _collectives.all_to_all_start = rec_start
        _collectives.Pending.wait = rec_wait
        pdist._segment, pdist.spmm = rec_segment, rec_spmm
        try:
            events.clear()
            _aggregate(local, _Rows(mesh, n_pad)(p["x"]))
            orders[mode] = list(events)
        finally:
            _collectives.all_to_all_start = start
            _collectives.Pending.wait = wait
            pdist._segment, pdist.spmm = segment, spmm
    return orders


def _train_checks(mesh, p, modes, rep):
    """Eval (the eval setup) and one SGD step (the dropout-free train
    setup) in each mode, from the JAX package's parameters."""
    for mode in modes:
        shards, n_pad = pdist.shard_hops(p["mats"], mesh.size, mode=mode)
        put = _Rows(mesh, n_pad)
        x, y, mask = put(p["x"]), put(p["y"]), put(p["mask"])

        model = _net(EVAL_SETUP, p["c"])
        model.init(p["f"], 2, torch.Generator().manual_seed(0))
        load_jax_params(model, p["eval_params"])
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        _, eval_step = ptrain.build_dist_steps(model, opt, mesh, shards)
        ev = eval_step(x, y, mask)
        rep[f"eval/{mode}"] = {k: float(v) for k, v in ev.items()}

        model = _net(TRAIN_SETUP, p["c"])
        model.init(p["f"], 2, torch.Generator().manual_seed(0))
        load_jax_params(model, p["train_params"])
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        train_step, _ = ptrain.build_dist_steps(model, opt, mesh, shards)
        loss = train_step(x, y, mask)
        rep[f"train/{mode}"] = dict(loss=float(loss),
                                    grads=_named(model, "grad"),
                                    params=_named(model, "param"))


def _gat(p, key, **kw):
    kw = dict(dict(hid_units=[8], n_heads=[2, 1], in_drop=0.0,
                   attn_drop=0.0, fused_attention=True), **kw)
    single = GATNetwork(p["c"], **kw)
    single.init(p["f"], 1, torch.Generator().manual_seed(0))
    load_jax_gat_params(single, p[key])
    return pattn.DistGATNetwork.from_single(single)


def _gat_checks(mesh, p, rep):
    dga, n_pad = pattn.shard_attention_gather(p["support"], mesh.size)
    put = _Rows(mesh, n_pad)
    x, y, mask = put(p["x"]), put(p["y"]), put(p["mask"])
    n = p["n"]

    model = _gat(p, "gat_params")
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    train_step, _ = ptrain.build_dist_steps(model, opt, mesh, [dga])
    rep["gat/logits"] = train_step.logits(x)[:n].numpy()
    loss = train_step(x, y, mask)
    rep["gat/train"] = dict(loss=float(loss), grads=_named(model, "grad"),
                            params=_named(model, "param"))

    model = _gat(p, "gat_res_params", residual=True)
    train_step, _ = ptrain.build_dist_steps(
        model, torch.optim.SGD(model.parameters(), lr=0.1), mesh, [dga])
    rep["gat/residual_logits"] = train_step.logits(x)[:n].numpy()

    # input and attention-coefficient dropout: the eval loss falls
    model = _gat(p, "gat_params", in_drop=0.4, attn_drop=0.4)
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    train_step, eval_step = ptrain.build_dist_steps(
        model, KerasAdam(model.parameters(), 0.01), mesh, [dga],
        generator=gen)
    before = eval_step(x, y, mask)
    losses = [float(train_step(x, y, mask)) for _ in range(10)]
    after = eval_step(x, y, mask)
    rep["gat/dropout"] = dict(losses=losses, before=float(before["loss"]),
                              after=float(after["loss"]),
                              acc=float(after["acc"]))


def _replica_checks(mesh, p, rep):
    """Three KerasAdam steps with dropout drawn per rank: every rank's
    parameters and per-tensor counts, gathered."""
    shards, n_pad = pdist.shard_hops(p["mats"], mesh.size, mode="halo")
    put = _Rows(mesh, n_pad)
    x, y, mask = put(p["x"]), put(p["y"]), put(p["mask"])
    model = _net(EVAL_SETUP, p["c"])
    model.init(p["f"], 2, torch.Generator().manual_seed(0))
    opt = KerasAdam(model.parameters(), 0.01)
    gen = torch.Generator().manual_seed(7 + mesh.rank)
    train_step, _ = ptrain.build_dist_steps(model, opt, mesh, shards,
                                            generator=gen)
    for _ in range(3):
        train_step(x, y, mask)
    flat = torch.cat([q.detach().reshape(-1) for q in model.parameters()])
    counts = torch.tensor([float(opt.state[q]["count"])
                           for q in model.parameters()])
    rep["replicas/params"] = _collectives.gather_rows(
        flat[None], mesh).numpy()
    rep["replicas/counts"] = _collectives.gather_rows(
        counts[None], mesh).numpy()


def _block_checks(mesh, p, rep):
    """``.block`` of 4 epochs against 4 per-epoch train and eval steps
    from the same start (dropout-free, Adam)."""
    shards, n_pad = pdist.shard_hops(p["mats"], mesh.size, mode="ring")
    put = _Rows(mesh, n_pad)
    arrays = [put(p[k]) for k in ("x", "y", "train_mask", "y", "val_mask",
                                  "y", "mask")]
    runs = {}
    for how in ("epochs", "block"):
        model = _net(TRAIN_SETUP, p["c"])
        model.init(p["f"], 2, torch.Generator().manual_seed(0))
        load_jax_params(model, p["train_params"])
        opt = KerasAdam(model.parameters(), 0.01)
        train_step, _ = ptrain.build_dist_steps(model, opt, mesh, shards)
        if how == "block":
            carry, table = train_step.block(None, 4, True, *arrays)
            runs[how] = dict(table=table, best=carry["best"]["params"])
            continue
        rows = []
        for _ in range(4):
            loss = train_step(*arrays[:3])
            st = train_step.eval_full(*arrays)
            rows.append(dict(st, train_loss=loss))
        runs[how] = dict(table={k: np.array([float(r[k]) for r in rows])
                                for k in rows[0]})
    rep["block"] = runs


def parity(data_path, checks=("spmm", "order", "train", "gat", "replicas",
                              "block", "dryrun")):
    """The distributed layer's checks on this world (every rank)."""
    with open(data_path, "rb") as f:
        p = pickle.load(f)
    mesh = make_mesh()
    rep = {"world": mesh.size}
    modes = p.get("modes", MODES)
    if "spmm" in checks:
        _spmm_checks(mesh, p, modes, rep)
    if "order" in checks:
        rep["order"] = _halo_order(mesh, p)
    if "train" in checks:
        _train_checks(mesh, p, modes, rep)
    if "gat" in checks:
        _gat_checks(mesh, p, rep)
    if "replicas" in checks:
        _replica_checks(mesh, p, rep)
    if "block" in checks:
        _block_checks(mesh, p, rep)
    if "dryrun" in checks:
        rep["dryrun"] = {m: dryrun.run(mesh.size, mode=m)["loss"]
                         for m in MODES + ("gat",)}
    return rep


def cli_runs(argvs, base):
    """``run_experiments.main`` on each argv in turn, inside this world,
    from the directory ``base/rank<r>`` (relative output paths land
    there); each run's best epoch's stats."""
    import os

    from h2gcn_tpu_torch import run_experiments

    cwd = os.path.join(base, f"rank{make_mesh().rank}")
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    out = []
    for argv in argvs:
        best = run_experiments.main(argv).objects["best_val_stats"]
        out.append({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in best.items() if k != "monitor"})
    return out

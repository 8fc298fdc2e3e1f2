"""GCNII (``h2gcn_tpu_torch/models/GCNII.py``) against its plain reference
(``benchmark/configs/gcnii.py``) on the CPU, at the published depth 64
and width 64 on a seeded 300-node graph, both sides from the same seeded
weights and dropout stream.

Tolerance 1e-5 of each compared tensor's largest magnitude: the program
aggregates through the ``segment`` SpMM (``index_add_``) where the
reference calls ``torch.sparse.mm``, and fuses the identity mapping into
one ``addmm``, so the two round in another order in float32 (2^-24 an
operation); over 64 layers that stays under 1e-6 here, while a changed
mechanism (a dropped residual, another β, another mask) moves the results
by far more than 1e-5."""

import ast
import math
import os
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark import graphs, harness, reference
from h2gcn_tpu_torch import run_experiments, tracing
from h2gcn_tpu_torch.models import GCNII

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SEED = 11
STEPS = 3
GRAPH = dict(nodes=300, edges=1500, features=16, feature_kind="uniform",
             classes=5, degree_exponent=0.6, graph_seed=0,
             split={"kind": "random", "train": 0.5, "val": 0.25})


def _rel(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def _program(seed):
    """The program set up through its CLI (no epochs) on the graph of
    ``seed``, and the reference on the same graph."""
    cell = harness.Cell("gcnii.arxiv-year")
    graph = graphs.generate(GRAPH, seed)
    with tempfile.TemporaryDirectory() as d, open(os.devnull, "w") as sink:
        prog = harness.Program(cell, graph, seed, "cpu", d, sink)
    inputs = reference.Inputs(graph, torch.device("cpu"))
    return prog, cell.reference.Model(cell.config, graph, inputs), inputs


@pytest.fixture(scope="module")
def pair():
    """:func:`_program`, with the reference's weights from the same seed;
    the tests that take it leave the program's weights as they are."""
    prog, ref, inputs = _program(SEED)
    return prog, ref, inputs, ref.init_params(harness.program_seed(SEED))


def _ref_step(ref, inputs, params, gen):
    logits = ref.forward(params, True, gen)
    loss = (reference.masked_cross_entropy(logits, inputs.y,
                                           inputs.train_mask)
            + ref.l2(params))
    return loss, torch.autograd.grad(loss, list(params.values()))


def _prog_train_loss(prog, gen):
    t = prog.tensors
    prog.model.train()
    logits = prog.model(t["adj"], t["features"], t["adj_hops"],
                        training=True, generator=gen)
    return prog.model.loss(logits, t["y_train"], t["train_mask"])


def test_the_weights_are_the_references(pair):
    prog, _, _, params = pair
    got = prog.params()
    assert set(got) == set(params) and len(params) == 68
    for k, v in params.items():
        assert torch.equal(got[k].detach(), v), k


@pytest.mark.parametrize("what", ["eval_logits", "train_loss", "grad1"])
def test_matches_the_reference(pair, what):
    prog, ref, inputs, params = pair
    t = prog.tensors
    seed = harness.program_seed(SEED) + 1
    if what == "eval_logits":
        prog.model.eval()
        with torch.no_grad():
            got = prog.model(t["adj"], t["features"], t["adj_hops"],
                             training=False)
            want = ref.forward(params, False, None)
        assert _rel(got, want) <= TOL
        return
    ref_params = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
    want_loss, want_grads = _ref_step(ref, inputs, ref_params,
                                      torch.Generator().manual_seed(seed))
    prog.model.zero_grad(set_to_none=True)
    loss = _prog_train_loss(prog, torch.Generator().manual_seed(seed))
    if what == "train_loss":
        assert abs(float(loss.detach()) - float(want_loss)) <= TOL * abs(
            float(want_loss))
        return
    loss.backward()
    got = prog.params()
    for k, g in zip(ref_params, want_grads):
        assert _rel(got[k].grad, g) <= TOL, k
    prog.model.zero_grad(set_to_none=True)


def test_three_adam_steps_match_the_reference():
    """The program's own train step (keras Adam, its dropout stream of
    seed + 1) three times, against the reference's."""
    prog, ref, inputs = _program(SEED + 1)
    seed = harness.program_seed(SEED + 1)
    params = {k: v.requires_grad_(True)
              for k, v in ref.init_params(seed).items()}
    opt = reference.KerasAdam(params, 0.01)
    gen = torch.Generator().manual_seed(seed + 1)
    for _ in range(STEPS):
        prog.objects["train_step"](**prog.tensors)
        _, grads = _ref_step(ref, inputs, params, gen)
        opt.step(params, dict(zip(params, grads)))
    for k, p in prog.params().items():
        assert _rel(p.detach(), params[k].detach()) <= TOL, k


def test_beta_schedule():
    want = [math.log(0.5 / l + 1) for l in range(1, 65)]
    assert GCNII.betas(64, 0.5) == want
    model = GCNII.GCNIINetwork(5)
    assert model.betas == want and len(want) == 64
    assert want[0] == pytest.approx(math.log(1.5))
    assert all(a > b for a, b in zip(want, want[1:]))


def test_the_cli_builds_the_published_model():
    graph = graphs.generate(GRAPH, 3)
    with tempfile.TemporaryDirectory() as d:
        graphs.write_sparsegraph(graph, os.path.join(d, "graph.npz"))
        args = run_experiments.main([
            "GCNII", "sparsegraph", "--dataset", "graph", "--dataset_path",
            d, "--setting", "exist", "--epochs", "0", "--device", "cpu",
            "--checkpoint_dir", os.path.join(d, "ckpt")])
    model = args.objects["model"]
    assert isinstance(model, GCNII.GCNIINetwork)
    assert (model.layers, model.hidden, model.alpha, model.dropout) == (
        64, 64, 0.1, 0.6)
    assert model.betas == GCNII.betas(64, 0.5)
    assert (model.wd1, model.wd2) == (0.01, 5e-4)
    assert len(list(model.parameters())) == 68
    assert args.objects["early_stopping"].patience == 100
    assert args.best_val_criteria == "val_loss"
    hops = args.objects["tensors"]["adj_hops"]
    assert len(hops) == 1 and hops[0].symmetric
    # Ã = D̃^-1/2 (A + I) D̃^-1/2 of the graph, self loops included
    assert hops[0].nnz == 2 * len(graph.src) + graph.n


def test_each_layer_is_a_span_around_its_spmm():
    prog = _program(SEED + 2)[0]
    n0 = tracing.counter("gcnii.layers")
    store = tracing.new_store()
    was = tracing.enable()
    try:
        prog.train_and_eval(harness._no_label)
    finally:
        tracing.enable(was)
    # the training forward's 64 layers and the evaluation's 64
    assert tracing.counter("gcnii.layers") - n0 == 128
    layers = [r for r in store.records if r.name == "gcnii.layer"]
    assert [r.attrs["l"] for r in layers] == list(range(1, 65)) * 2
    children = [r for r in store.records if r.name == "spmm"
                and r.parent is not None and r.parent.name == "gcnii.layer"]
    assert len(children) == 128
    assert "gcnii.layer" in tracing.SPANS


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "benchmark/configs/gcnii.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch", "numpy", "benchmark"}

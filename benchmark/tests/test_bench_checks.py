"""What ``correct`` is decided by: the control fails, each fault the
cells can have fails, a sound run passes."""

import time

import pytest
import torch

from benchmark import checks, graphs, harness
from benchmark.tests.conftest import TINY, tiny_cell


def _readings(workload, seed=5, **kw):
    cell = tiny_cell(workload)
    g = graphs.generate(TINY[workload], seed)
    return cell, harness.reference_readings(cell, g, seed,
                                            torch.device("cpu"), **kw)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails(workload):
    cell, ref = _readings(workload)
    _, ctl = _readings(workload, precision="tf32")
    values = checks.compare(ctl, ref)
    assert not checks.verdict(values, cell.limits), values


def _no_step(prog):
    prog.optimizer.step = lambda closure=None: None


def _half_batch(prog):
    model = prog.model
    loss = model.loss

    def half(logits, labels, mask):
        idx = torch.nonzero(mask).ravel()
        mask = mask.clone()
        mask[idx[1::2]] = 0
        return loss(logits, labels, mask)

    model.loss = half


def _answer(prog):
    model = prog.model
    forward = model.forward
    node = int(torch.nonzero(prog.tensors["train_mask"])[0])

    def altered(*args, **kw):
        out = forward(*args, **kw).clone()
        out[node, 0] += 1.0
        return out

    model.forward = altered


@pytest.mark.parametrize("fault", [_no_step, _half_batch, _answer])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_fault_is_caught(workload, fault):
    r = harness.run_cell(workload, 11, 0.3, False, t_start=time.perf_counter(),
                         device="cpu", cell=tiny_cell(workload),
                         traffic=TINY[workload], hooks=fault)
    assert not r["correct"], r["checks"]


def test_compare_flags_missing_leaves():
    ref = {"loss": [1.0], "eval_loss": [1.0], "grad1": {"a": 1.0, "b": 2.0},
           "delta3": {"a": 1.0, "b": 1.0}}
    prog = dict(ref, grad1={"a": 1.0})
    with pytest.raises(ValueError):
        checks.compare(prog, ref)


def test_compare_values():
    ref = {"loss": [2.0, 2.0], "eval_loss": [1.0, 1.0],
           "grad1": {"a": 1.0, "b": 4.0, "c": 1e-9},
           "delta3": {"a": 1.0, "b": 1.0, "c": 0.5}}
    prog = {"loss": [2.0, 2.2], "eval_loss": [1.0, 1.0],
            "grad1": {"a": 1.5, "b": 4.0, "c": 1e-9},
            "delta3": {"a": 1.0, "b": 1.0, "c": 0.0}}
    v = checks.compare(prog, ref)
    assert v["loss"] == pytest.approx(0.1)
    assert v["eval_loss"] == 0.0
    # the median leaf norm (1.0) is the larger scale for leaf a
    assert v["grad1"] == pytest.approx(0.5)
    # leaf c's gradient is under a thousandth of the median: left out
    assert v["delta3"] == 0.0
    assert checks.verdict(v, {"loss": 0.2}) and not checks.verdict(
        v, {"loss": 0.05}) and not checks.verdict(v, {})


def test_control_fails_at_cell_size(cuda):
    from benchmark import calibrate

    cell = harness.Cell("h2gcn2.squirrel")
    out = calibrate.readings(cell, 1234)
    assert checks.verdict(out["program"], cell.limits), out["program"]
    for name in ("control", "half_batch", "answer"):
        assert not checks.verdict(out[name], cell.limits), (name, out[name])

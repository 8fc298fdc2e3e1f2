"""GCNII layer forwards an epoch (the program's ``gcnii.layers`` counter)
over the tracer's stretch (``_spans.py``): the training forward's layers
and the evaluation's, 128 at 64 layers."""

from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    s = _sp.stretch(run)
    if s is None or "gcnii.layers" not in s.counters:
        return None
    return s.counters["gcnii.layers"] / s.epochs

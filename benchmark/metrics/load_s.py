"""Seconds of the program's dataset load (its ``setup.load`` span: the
sparsegraph npz read, the symmetrization, the split)."""

from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    return _sp.setup_seconds(run, "setup.load")

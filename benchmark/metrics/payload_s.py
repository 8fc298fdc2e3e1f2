"""Seconds of GAT's attention set-up (the program's ``setup.payload``
span: the self-looped support and the fused payload's tables)."""

from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    return _sp.setup_seconds(run, "setup.payload")

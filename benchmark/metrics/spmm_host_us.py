"""Mean host microseconds of one SpMM call (the program's ``spmm`` span,
forward and backward, less any span inside it) over the tracer's stretch
(``_spans.py``): the dispatch and the kernel launches from the host."""

import statistics
from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    s = _sp.stretch(run)
    if s is None:
        return None
    us = [1e6 * t for t in _sp.self_seconds(s.records, "spmm")]
    return statistics.fmean(us) if us else None

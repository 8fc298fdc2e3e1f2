"""Mean host microseconds of one GCNII layer's forward outside its SpMM
(the program's ``gcnii.layer`` span less the ``spmm`` span inside it) over
the tracer's stretch (``_spans.py``): the dropout, the initial-residual
mix, the identity-mapped product and the ReLU, dispatched from the
host."""

import statistics
from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    s = _sp.stretch(run)
    if s is None:
        return None
    us = [1e6 * t for t in _sp.self_seconds(s.records, "gcnii.layer")]
    return statistics.fmean(us) if us else None

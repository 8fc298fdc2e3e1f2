"""The program's device-to-host readbacks an epoch (its ``readbacks``
counter) over the tracer's stretch (``_spans.py``): the post-epoch
callbacks' conversions of device scalars."""

from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    s = _sp.stretch(run)
    if s is None:
        return None
    return s.counters.get("readbacks", 0) / s.epochs

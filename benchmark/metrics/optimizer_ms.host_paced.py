"""Host milliseconds an epoch in the optimizer step (the program's
``step.train.optimizer`` span) over the tracer's stretch
(``_spans.py``): KerasAdam's per-leaf work."""

from pathlib import Path

from benchmark import harness

_sp = harness.load_module(Path(__file__).with_name("_spans.py"),
                          "bench_spans")


def read(run):
    s = _sp.stretch(run)
    if s is None:
        return None
    ms = [1e3 * r.seconds for r in s.records
          if r.name == "step.train.optimizer"]
    return sum(ms) / s.epochs if ms else None

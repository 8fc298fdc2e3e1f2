"""The program's own spans and counters (``h2gcn_tpu_torch.tracing``), for
the per-layer metrics that read them.

:func:`stretch`, on its first call in a traced run, turns the program's
tracer on, runs ``max(20, round(1 / run.epoch_s))`` epochs (about a
second) through the harness's epoch body without labels, turns the tracer
off, and keeps on ``run`` the stretch's span records and the change of
each counter; its epochs count as attempted and their non-finite losses
as failed. The harness's profiled stretch ran before, with the tracer off.
:func:`setup_seconds` reads a set-up span of the run's own store, which
the CLI's ``main`` hands out as ``args.objects["spans"]``. A program
without a tracer or a store reads as nothing (None).
"""

import types

from benchmark import harness

MIN_EPOCHS, SECONDS = 20, 1.0


def _tracing():
    try:
        from h2gcn_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def stretch(run):
    """``.epochs``, ``.records`` and ``.counters`` (each counter's change)
    of the traced stretch, or None."""
    if hasattr(run, "program_spans"):
        return run.program_spans
    run.program_spans = None
    tracing = _tracing()
    store = run.program.objects.get("spans")
    if tracing is None or store is None:
        return None
    n = max(MIN_EPOCHS, round(SECONDS / run.epoch_s))
    n0, c0 = len(store.records), tracing.counters()
    was = tracing.enable()
    try:
        for _ in range(n):
            run.program.train_and_eval(harness._no_label)
            run.failed += not run.program.post_epoch(harness._no_label)
    finally:
        tracing.enable(was)
    run.attempted += n
    run.program_spans = types.SimpleNamespace(
        epochs=n, records=store.records[n0:],
        counters={k: v - c0.get(k, 0)
                  for k, v in tracing.counters().items()})
    return run.program_spans


def self_seconds(records, name):
    """Each span called ``name``'s seconds outside its child spans."""
    child = {}
    for r in records:
        if r.parent is not None:
            child[id(r.parent)] = child.get(id(r.parent), 0.0) + r.seconds
    return [r.seconds - child.get(id(r), 0.0) for r in records
            if r.name == name]


def setup_seconds(run, name):
    """Seconds of the run's set-up span ``name``, or None."""
    store = run.program.objects.get("spans")
    if store is None:
        return None
    found = [r.seconds for r in store.records if r.name == name]
    return sum(found) if found else None

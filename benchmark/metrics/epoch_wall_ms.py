"""Mean milliseconds of an epoch on the host clock, over the traced run's
first stretch (no profiler, the window's own loop): the stretch's seconds
over its epochs."""


def read(run):
    return 1e3 * run.epoch_s if run.epochs else None

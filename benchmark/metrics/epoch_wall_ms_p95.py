"""Nearest-rank 95th percentile of the epochs of the traced run's first
stretch, each on the host clock from the previous epoch's sync to its
own, in milliseconds."""

from benchmark import harness


def read(run):
    return 1e3 * harness.p95(run.epoch_times) if run.epoch_times else None

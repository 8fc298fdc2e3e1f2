"""The program's own kernel-launch counter
(``run_experiments.kernel_launches()``, summed) an epoch, over the traced
run's first stretch."""


def read(run):
    return run.launches_per_epoch or None

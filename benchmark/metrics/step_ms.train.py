"""Mean milliseconds of the train step, host clock from its call to the
sync after it, over the traced run's stretch with a sync a step."""

import statistics


def read(run):
    return 1e3 * statistics.fmean(run.train_s) if run.train_s else None

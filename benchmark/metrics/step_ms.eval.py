"""Mean milliseconds of the eval step, host clock from its call to the
sync after it, over the traced run's stretch with a sync a step."""

import statistics


def read(run):
    return 1e3 * statistics.fmean(run.eval_s) if run.eval_s else None

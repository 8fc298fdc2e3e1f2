"""The whole epoch's share of the card's peak: the least time of the work
an epoch needs (the configuration's ``epoch_work``, from shapes alone, at
the float32 and memory peaks) over the measured epoch time, in percent."""

from benchmark import work


def read(run):
    fn = getattr(run.reference, "epoch_work", None)
    if fn is None or run.program.device.type != "cuda":
        return None
    least, _ = work.least_seconds(*fn(run.graph, run.program.device))
    return 100.0 * least / run.epoch_s

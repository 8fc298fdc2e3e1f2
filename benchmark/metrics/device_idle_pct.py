"""Device idle share of the traced window: the window less the union of
the device's kernel, copy and set intervals, in percent."""


def read(run):
    t = run.trace
    if run.program.device.type != "cuda" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

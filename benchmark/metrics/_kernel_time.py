"""Device milliseconds a call of ``fn``: CUDA events around ``calls``
launches after ``warmup`` untimed ones."""

import torch


def ms_per_call(fn, calls=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls

"""Summarize a ``torch.profiler`` chrome trace: where an epoch's time goes.

    python -m h2gcn_tpu_torch.trace_summary <trace.json> [--epochs N] [--top K]

Reads the trace that ``run_experiments --profile_dir`` writes (epochs 3-5)
and prints one JSON object: the traced window on the host clock, the
device's busy time (the union of kernel, memcpy and memset intervals) and
idle share, the device kernels by total time, the CUDA runtime calls on
the host by total time (launches, copies, synchronizations), the host's
aten ops by total time (inclusive of the ops they call), and the
counts per epoch when ``--epochs`` says how many epochs the window holds.
A trace taken on the CPU has no device events; its device fields are 0.
"""

from __future__ import annotations

import argparse
import collections
import json

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def _by_name(events, top):
    acc = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        acc[e["name"]][0] += 1
        acc[e["name"]][1] += e["dur"]
    rows = sorted(acc.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": k[:120], "count": c, "ms": d / 1e3} for k, (c, d) in rows]


def summarize(trace: dict, epochs: int = 0, top: int = 15) -> dict:
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError("the trace holds no complete events")
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    window_us = hi - lo
    out = {
        "window_ms": window_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / window_us,
        "kernel_ms": sum(e["dur"] for e in kernels) / 1e3,
        "kernel_launches": len(kernels),
        "copies": sum(e.get("cat") == "gpu_memcpy" for e in device),
        "kernels": _by_name(kernels, top),
        "runtime_calls": _by_name(runtime, top),
        "host_ops_inclusive": _by_name(ops, top),
    }
    if epochs:
        out["per_epoch"] = {
            "window_ms": out["window_ms"] / epochs,
            "device_busy_ms": out["device_busy_ms"] / epochs,
            "kernel_launches": len(kernels) / epochs,
            "copies": out["copies"] / epochs,
        }
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trace")
    parser.add_argument("--epochs", type=int, default=0,
                        help="epochs the traced window holds")
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    print(json.dumps(summarize(trace, args.epochs, args.top)))


if __name__ == "__main__":
    main()

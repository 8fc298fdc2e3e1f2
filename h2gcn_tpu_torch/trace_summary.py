"""Summarize a ``torch.profiler`` chrome trace: where an epoch's time goes.

    python -m h2gcn_tpu_torch.trace_summary <trace.json> [--epochs N] [--top K]

Reads the trace that ``run_experiments --profile_dir`` writes (epochs 3-5)
and prints one JSON object: the traced window on the host clock, the
device's busy time (the union of kernel, memcpy and memset intervals) and
idle share, the device kernels by total time, the CUDA runtime calls on
the host by total time (launches, copies, synchronizations), the host's
aten ops by total time (inclusive of the ops they call), the program's
spans (:data:`h2gcn_tpu_torch.tracing.SPANS`, which ``--profile_dir``
turns on) by host time and self time (outside their child spans), the
device's idle gaps by the innermost program span and the innermost host
op at each gap's middle, and the counts per epoch when ``--epochs`` says
how many epochs the window holds. A trace taken on the CPU has no device
events; its device fields are 0, and its one idle gap is the window.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json

from .tracing import SPANS

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(events, starts, t, reach=4000):
    """The latest-starting event of ``events`` (sorted by start) that
    covers time ``t``, among the ``reach`` that start last before it, or
    None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        if events[j]["ts"] + events[j]["dur"] > t:
            return events[j]
    return None


def span_host_time(spans, top):
    """The program's spans by name: count, host ms and self ms (less the
    spans nested directly inside each, on the same thread)."""
    self_us = {id(e): e["dur"] for e in spans}
    by_thread = collections.defaultdict(list)
    for e in spans:
        by_thread[e.get("tid")].append(e)
    for evs in by_thread.values():
        stack = []
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                self_us[id(stack[-1])] -= e["dur"]
            stack.append(e)
    acc = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for e in spans:
        row = acc[e["name"]]
        row[0] += 1
        row[1] += e["dur"]
        row[2] += self_us[id(e)]
    rows = sorted(acc.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"name": k, "count": c, "ms": d / 1e3, "self_ms": s / 1e3}
            for k, (c, d, s) in rows]


def idle_gaps(lo, hi, busy, spans, ops, top):
    """Idle ms of the device in ``[lo, hi]`` outside the ``busy``
    intervals, by ``<span>:<op>``: the innermost program span and host op
    at each gap's middle ("outside" and "none" where there is none)."""
    spans = sorted(spans, key=lambda e: e["ts"])
    ops = sorted(ops, key=lambda e: e["ts"])
    span_ts, op_ts = [e["ts"] for e in spans], [e["ts"] for e in ops]
    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in _merged(busy) for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        span = _innermost(spans, span_ts, mid)
        op = _innermost(ops, op_ts, mid)
        gaps[(span["name"] if span else "outside") + ":"
             + (op["name"][:80] if op else "none")] += b - a
    rows = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return [{"name": k, "ms": v / 1e3} for k, v in rows]


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
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in SPANS]
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    busy_us = _union_us(busy)
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
        "span_host_time": span_host_time(spans, top),
        "idle_gaps_by_span": idle_gaps(lo, hi, busy, spans, ops, top),
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

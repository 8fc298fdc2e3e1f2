"""Reading a ``torch.profiler`` chrome trace: the device's busy time in the
traced window, the device operations that took most time, and the idle
gaps by what the host was doing.

The interval arithmetic is a frozen copy of the program's
``trace_summary._union_us``, so that a change to the program cannot move
this yardstick.
"""

from __future__ import annotations

import bisect
import collections

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench_window"
# the harness's labels around the parts of an epoch in the traced window
LABELS = ("train_step", "test_step", "sync", "post_epoch")


def union_us(intervals) -> float:
    """Length of the union of ``(lo, hi)`` intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def merged(intervals) -> list:
    """The union of ``(lo, hi)`` intervals as disjoint sorted intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(events, starts, t):
    """The latest-starting event of ``events`` (sorted by start) that
    covers time ``t``, or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4000), -1):
        e = events[j]
        if e["ts"] + e["dur"] > t:
            return e
    return None


def summarize(trace: dict, top: int = 10) -> dict:
    """``busy_s`` and ``window_s`` of the ``bench_window`` annotation,
    ``device_ops`` (the ``top`` device operations by seconds inside it)
    and ``idle_gaps`` (idle seconds inside it, by the harness's label and
    the innermost host operation at each gap's middle), as
    ``[[name, seconds], ...]``."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError("the trace holds no bench_window annotation")
    lo = wins[0]["ts"]
    hi = lo + wins[0]["dur"]
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                device.append((a, b, e["name"]))
    busy = merged((a, b) for a, b, _ in device)
    by_op = collections.defaultdict(float)
    for a, b, name in device:
        by_op[name[:120]] += (b - a) / 1e6
    host = sorted((e for e in events if e.get("cat") == "cpu_op"),
                  key=lambda e: e["ts"])
    labels = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") in LABELS), key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    label_starts = [e["ts"] for e in labels]
    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = _innermost(labels, label_starts, mid)
        op = _innermost(host, host_starts, mid)
        name = (label["name"] if label else "outside") + ":" + (
            op["name"][:80] if op else "none")
        gaps[name] += (b - a) / 1e6
    busy_us = sum(b - a for a, b in busy)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": [[k, v] for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
    }

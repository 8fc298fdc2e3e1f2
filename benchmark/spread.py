"""Where the spread of a cell's runs comes from: the cell run as separate
``benchmark/run.py --trace 0`` processes in a row, as the check runs them,
each watched from outside while it runs and from inside over its window.

    python3 benchmark/spread.py --workload <name> --seeds <n> [<n> ...] \
        --seconds 10 --out <file.jsonl>

Per process, one JSON line in ``--out``:

- its index in the call, its seed, its result line's metrics and
  ``correct``;
- the window's epochs: mean, 95th percentile, deciles, and the median of
  each second of the window (``per_s_ms``; the first and last as
  ``first_s_ms``, ``last_s_ms``), so that a slow stretch can be told from
  a slow process;
- the Python collections in the window (``gc.callbacks``): count and
  seconds, by generation;
- each thread's CPU seconds over the window and the CPUs it was seen on,
  sampled from ``/proc/<pid>/task/*/stat`` every ``SAMPLE_S``; the main
  thread is the one whose id is the process's, autograd's device thread is
  named ``pt_autograd_<device>``;
- the process's allowed CPUs, its resident memory at the window's ends,
  the cores' MHz (cpufreq) over the window, or null where the machine does
  not give them;
- ``host_loop_us``: the time of a fixed loop of Python in this watching
  process, every ``SAMPLE_S``: a gauge of the speed of the host's CPUs
  beside the run, over set-up, over the window and per second of it;
- the card's SM clock, power draw and temperature (``nvidia-smi`` every
  ``SMI_MS``) over the window.

The first line gives the machine: the card, its PCI bus id and NUMA node,
the NUMA nodes' CPUs. At the end, on standard output: a table with a row a
process, each factor's correlation with the epoch over the processes, and
each metric's spread and the bound :func:`rule` gives it. Not part of a
benchmark run; it reads, and sets nothing on the machine.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import math
import os
import runpy
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUN = ROOT / "benchmark" / "run.py"
SAMPLE_S = 0.1
SMI_MS = 500
LOOP_N = 20000
SMI_QUERY = "clocks.sm,power.draw,temperature.gpu"
PAGE = os.sysconf("SC_PAGE_SIZE")


def parse_cpulist(text: str) -> list:
    """``0-25,52-77`` -> the CPU numbers, in order."""
    cpus = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.extend(range(int(lo), int(hi or lo) + 1))
    return cpus


def _read(path: Path):
    try:
        return path.read_text().strip()
    except OSError:
        return None


def gpu_numa_node(bus_id: str, sysfs: Path = Path("/sys")):
    """The NUMA node of the PCI device ``bus_id`` (as ``nvidia-smi`` gives
    it, ``00000000:19:00.0``), or None where sysfs gives none (``-1``, or
    no such device)."""
    if not bus_id or ":" not in bus_id:
        return None
    dom, rest = bus_id.lower().split(":", 1)
    text = _read(sysfs / "bus/pci/devices" / f"{dom[-4:]}:{rest}" /
                 "numa_node")
    if text is None or int(text) < 0:
        return None
    return int(text)


def numa_nodes(sysfs: Path = Path("/sys")) -> dict:
    """``{node: [cpu, ...]}`` of the machine's NUMA nodes, empty where
    sysfs lists none."""
    out = {}
    for d in sorted(glob.glob(str(sysfs / "devices/system/node/node[0-9]*"))):
        text = _read(Path(d) / "cpulist")
        if text is not None:
            out[int(Path(d).name[4:])] = parse_cpulist(text)
    return out


def _smi(*query) -> list:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(query),
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [x.strip() for x in out.stdout.strip().split(",")]


def _number(text):
    try:
        return float(text)
    except (TypeError, ValueError):
        return None


def _median(xs):
    return statistics.median(xs) if xs else None


def _threads(pid: int) -> dict:
    """``{tid: (name, cpu, cpu_seconds)}`` from ``/proc/<pid>/task``."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for d in glob.glob(f"/proc/{pid}/task/*"):
        stat, name = _read(Path(d) / "stat"), _read(Path(d) / "comm")
        if stat is None:
            continue
        f = stat.rsplit(")", 1)[1].split()
        # fields 14, 15 (utime, stime) and 39 (processor), counted from 1
        out[int(Path(d).name)] = (name, int(f[36]),
                                  (int(f[11]) + int(f[12])) / tick)
    return out


def loop_us() -> float:
    """Microseconds of a fixed loop of Python on this thread."""
    t = time.perf_counter()
    s = 0
    for i in range(LOOP_N):
        s += i
    return 1e6 * (time.perf_counter() - t)


class Watch:
    """Samples a running process from outside: its threads and memory,
    the host's speed at a fixed loop, the cores' MHz and the card's
    clocks."""

    def __init__(self, pid: int):
        self.pid, self.samples, self.smi = pid, [], []
        self.stop = threading.Event()
        self.smi_proc = None
        try:
            self.smi_proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=" + SMI_QUERY,
                 "--format=csv,noheader,nounits", "-lms", str(SMI_MS)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            pass
        self.threads = [threading.Thread(target=f, daemon=True) for f in (
            [self._sample] + ([self._read_smi] if self.smi_proc else []))]
        for t in self.threads:
            t.start()

    def _read_smi(self):
        for line in self.smi_proc.stdout:
            self.smi.append((time.perf_counter(),
                             [_number(x) for x in line.split(",")]))

    def _sample(self):
        freq_files = sorted(glob.glob(
            "/sys/devices/system/cpu/cpu[0-9]*/cpufreq/scaling_cur_freq"))
        while not self.stop.is_set():
            t = time.perf_counter()
            mhz = {int(Path(f).parts[-3][3:]): _number(_read(Path(f)))
                   for f in freq_files}
            rss = _read(Path(f"/proc/{self.pid}/statm"))
            rss = int(rss.split()[1]) * PAGE / 2 ** 20 if rss else None
            self.samples.append((t, _threads(self.pid), loop_us(), mhz, rss))
            self.stop.wait(SAMPLE_S)

    def close(self):
        self.stop.set()
        if self.smi_proc is not None:
            self.smi_proc.terminate()
            self.smi_proc.wait(timeout=10)
        for t in self.threads:
            t.join(timeout=10)

    def summary(self, t0: float, t1: float) -> dict:
        """The samples inside the window ``[t0, t1]``."""
        samples = [s for s in self.samples if t0 <= s[0] <= t1]
        threads = {}
        if samples:
            first, last = samples[0][1], samples[-1][1]
            for tid, (name, _, cpu_s) in last.items():
                seen = sorted({s[1][tid][1] for s in samples if tid in s[1]})
                threads[str(tid)] = {
                    "name": name, "cpus_seen": seen,
                    "cpu_s": cpu_s - first.get(tid, (0, 0, 0.0))[2]}
        mhz = {}
        for s in samples:
            for cpu, v in s[3].items():
                if v is not None:
                    mhz.setdefault(cpu, []).append(v / 1e3)
        smi = [v for t, v in self.smi if t0 <= t <= t1 and None not in v]
        rss = [s[4] for s in samples if s[4] is not None]
        return {
            "threads": threads,
            "host_loop_us": {
                "median": _median([s[2] for s in samples]),
                "setup": _median([s[2] for s in self.samples if s[0] < t0]),
                "per_s": [_median([s[2] for s in samples
                                   if k <= s[0] - t0 < k + 1])
                          for k in range(int(t1 - t0))]},
            "rss_mib": [rss[0], rss[-1]] if rss else None,
            "mhz": {c: statistics.mean(v) for c, v in mhz.items()} or None,
            "smi": {k: _median([v[i] for v in smi]) for i, k in enumerate(
                ("sm_mhz", "power_w", "temp_c"))}
            | {"sm_mhz_min": min((v[0] for v in smi), default=None)},
        }


def _p95(xs):
    ranked = sorted(xs)
    return ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]


def window_summary(t0: float, t1: float, times: list, events: list) -> dict:
    """The window's epochs (``times``, seconds, the first from ``t0``) and
    the collections that began and ended in it (``events``: ``(time,
    phase, generation)`` as ``gc.callbacks`` see them), in ms."""
    ms, ends, s = [], [], t0
    for x in times:
        s += x
        ms.append(1e3 * x)
        ends.append(s)
    per_s = [_median([m for m, e in zip(ms, ends) if k <= e - t0 < k + 1])
             for k in range(int(t1 - t0) + 1)]
    per_s = [x for x in per_s if x is not None]
    gcs, start = {}, {}
    for t, phase, gen in events:
        if not t0 <= t <= t1:
            continue
        if phase == "start":
            start[gen] = t
        elif gen in start:
            n, sec = gcs.get(gen, (0, 0.0))
            gcs[gen] = (n + 1, sec + t - start.pop(gen))
    return {"t0": t0, "t1": t1, "epochs": len(ms),
            "epoch_ms": statistics.fmean(ms), "p95_ms": _p95(ms),
            "deciles_ms": statistics.quantiles(ms, n=10),
            "first_s_ms": per_s[0], "last_s_ms": per_s[-1],
            "per_s_ms": per_s,
            "gc": {str(g): {"n": n, "s": sec}
                   for g, (n, sec) in sorted(gcs.items())}}


def child(stats_path: str, argv: list) -> None:
    """Runs ``benchmark/run.py argv`` in this process, recording its
    window's epochs and the collections in it, then writes them."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    events, inside = [], {}
    gc.callbacks.append(lambda phase, info: events.append(
        (time.perf_counter(), phase, info["generation"])))
    window = harness._window

    def watched(prog, seconds):
        t0, times, span, failed = window(prog, seconds)
        inside.update(window_summary(t0, t0 + span, times, events))
        return t0, times, span, failed

    harness._window = watched
    sys.argv = [str(RUN)] + argv
    code = 0
    try:
        runpy.run_path(str(RUN), run_name="__main__")
    except SystemExit as err:
        code = err.code or 0
    with open(stats_path, "w") as f:
        json.dump(inside, f)
    sys.exit(code)


def machine() -> dict:
    bus = (_smi("pci.bus_id") or [None])[0]
    nodes = numa_nodes()
    return {"gpu": _smi("name", "power.limit"), "gpu_bus_id": bus,
            "gpu_numa_node": gpu_numa_node(bus),
            "numa_nodes": {str(k): v for k, v in nodes.items()} or None,
            "kernel": os.uname().release, "cpus": os.cpu_count()}


def _allowed(pid: int):
    for line in (_read(Path(f"/proc/{pid}/status")) or "").splitlines():
        if line.startswith("Cpus_allowed_list:"):
            return line.split(":", 1)[1].strip()
    try:
        return ",".join(map(str, sorted(os.sched_getaffinity(pid))))
    except OSError:
        return None


def run_one(workload: str, seed: int, seconds: float, stats: Path) -> dict:
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(stats), "--workload", workload, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watch = Watch(proc.pid)
    allowed = _allowed(proc.pid)
    out, err = proc.communicate()
    watch.close()
    row = {"seed": seed, "pid": proc.pid, "rc": proc.returncode,
           "cpus_allowed": allowed, "stderr_tail": err[-600:]}
    try:
        result = json.loads(out.strip().splitlines()[-1])
        inside = json.loads(stats.read_text())
    except (IndexError, ValueError, OSError):
        return row
    stats.unlink()
    row["correct"] = result["correct"]
    row["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
    row["window"] = {k: v for k, v in inside.items() if k not in ("t0", "t1")}
    row.update(watch.summary(inside["t0"], inside["t1"]))
    return row


def spread(values) -> dict:
    """A set's median, its IQR over the median (``statistics.quantiles``'
    quartiles) and its range over the median."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "iqr": (q3 - q1) / med,
            "range": (max(values) - min(values)) / med}


def round_up(x: float, digits: int = 2) -> float:
    """``x`` rounded up to ``digits`` significant digits."""
    e = math.floor(math.log10(x)) - digits + 1
    return round(math.ceil(x / 10.0 ** e - 1e-9) * 10.0 ** e, max(0, -e))


def rule(iqr: float, rng: float) -> float:
    """An end-to-end bound from a set's IQR and range over its median:
    ``max(4.5 IQR, 2 range)``, rounded up to two significant digits,
    within [0.01, 0.25]."""
    x = max(4.5 * iqr, 2 * rng)
    return min(0.25, max(0.01, round_up(x) if x > 0 else 0.0))


def bound(sets) -> float:
    """The bound from sets of runs of one metric: the rule on the set
    that gives the widest."""
    return max(rule(s["iqr"], s["range"]) for s in map(spread, sets))


FACTORS = {
    "host_loop_us": lambda r: r["host_loop_us"]["median"],
    "sm_mhz": lambda r: r["smi"]["sm_mhz"],
    "main_cpu_s": lambda r: r["threads"][str(r["pid"])]["cpu_s"],
    "gc_ms": lambda r: 1e3 * sum(g["s"] for g in r["window"]["gc"].values()),
    "setup_s": lambda r: r["metrics"]["setup_s"],
}


def report(rows: list) -> str:
    """The table, the factors' correlations with the epoch and the
    metrics' spreads, over the processes that gave a result."""
    rows = [r for r in rows if "window" in r]
    if not rows:
        return "no process gave a result"

    def f(x, p=3):
        return "—" if x is None else f"{x:.{p}f}"
    head = ("| # | seed | epoch ms | p95 ms | setup s | first s | last s "
            "| p10-p90 ms | main cpu s | autograd cpu s | host loop us "
            "| SM MHz (min) | W | gc n / ms |")
    lines = [head, "|" + " --- |" * (head.count("|") - 1)]
    for r in rows:
        w, smi = r["window"], r["smi"]
        auto = [t["cpu_s"] for t in r["threads"].values()
                if t["name"].startswith("pt_autograd")]
        lines.append(
            f"| {r['index']} | {r['seed']} | {f(w['epoch_ms'])} "
            f"| {f(w['p95_ms'])} "
            f"| {f(r['metrics']['setup_s'], 2)} | {f(w['first_s_ms'])} "
            f"| {f(w['last_s_ms'])} | {f(w['deciles_ms'][0])}-"
            f"{f(w['deciles_ms'][-1])} | {f(FACTORS['main_cpu_s'](r), 2)} "
            f"| {f(auto[0] if auto else None, 2)} "
            f"| {f(r['host_loop_us']['median'], 0)} "
            f"| {f(smi['sm_mhz'], 0)} ({f(smi['sm_mhz_min'], 0)}) "
            f"| {f(smi['power_w'], 0)} "
            f"| {sum(g['n'] for g in w['gc'].values())} / "
            f"{f(FACTORS['gc_ms'](r), 1)} |")
    epochs = [r["window"]["epoch_ms"] for r in rows]
    for name, get in FACTORS.items():
        try:
            r = statistics.correlation(epochs, [get(x) for x in rows])
            lines.append(f"corr(epoch, {name}) = {r:.3f}")
        except (statistics.StatisticsError, TypeError, KeyError):
            lines.append(f"corr(epoch, {name}) = —")
    series = {f"window {k}": [r["window"][k] for r in rows]
              for k in ("epoch_ms", "p95_ms")}
    series.update({k: [r["metrics"][k] for r in rows]
                   for k in rows[0]["metrics"]})
    for metric, values in series.items() if len(rows) >= 2 else ():
        s = spread(values)
        lines.append(f"{metric}: median {s['median']:.6g}, IQR/median "
                     f"{s['iqr']:.4f}, range/median {s['range']:.4f}, "
                     f"rule {rule(s['iqr'], s['range'])}")
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2:])
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    info = {"machine": machine()}
    print(json.dumps(info), flush=True)
    rows = []
    with open(out, "a") as f:
        f.write(json.dumps(info) + "\n")
        for index, seed in enumerate(a.seeds):
            row = run_one(a.workload, seed, a.seconds,
                          out.with_suffix(f".{index}.stats.json"))
            row.update(index=index, workload=a.workload)
            rows.append(row)
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps({k: row.get(k) for k in (
                "index", "seed", "rc", "correct", "metrics")}), flush=True)
    print(report(rows))


if __name__ == "__main__":
    main()

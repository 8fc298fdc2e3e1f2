"""One run of one cell: the graph from the seed, the program set up through
its own CLI, three checked training steps, the warm-up, the measured
window (or, traced, the per-layer stretches), then the plain reference and
the comparison, and the one result line.

Everything that belongs to one cell is found by name: the configuration
(``configs/<config>.json`` and its reference ``configs/<config>.py``),
the traffic (``traffic/<traffic>.json``), the limits of its comparison
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``). This file changes for none of them.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "h2gcn_tpu")
WARMUP_EPOCHS = 5
CHECK_STEPS = 3
# the traced run: the share of --seconds timed without the profiler with a
# sync an epoch, then with a sync a step, then the profiled stretch's
# target seconds and its fewest and most epochs
STRETCH_SHARE, STEPS_SHARE = 0.4, 0.2
PROFILE_S, PROFILE_MIN, PROFILE_MAX = 2.0, 3, 50


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``h2gcn_tpu_torch`` is not ``h2gcn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_seed(seed: int) -> int:
    """The program's ``--random_seed`` for a benchmark seed (the program
    reads a seed of 0 as its default)."""
    return seed % (1 << 62) + 1


class Cell:
    def __init__(self, workload: str, manifest: dict = None):
        manifest = manifest or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.manifest = manifest
        self.cell = cells[workload]
        self.name = workload
        self.config_name = self.cell["config"]
        self.config = load_json(BENCH / "configs" / f"{self.config_name}.json")
        self.traffic = load_json(BENCH / "traffic" /
                                 f"{self.cell['traffic']}.json")
        self.reference = load_module(
            BENCH / "configs" / f"{self.config_name}.py",
            f"bench_ref_{self.config_name}")
        lim = BENCH / "limits" / f"{workload}.json"
        self.limits = load_json(lim)["limits"] if lim.exists() else {}

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in a run of ``trace``."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if self.name in m.get("workloads", [self.name])]


class Program:
    """The program under test, set up through its CLI's ``main`` with no
    epochs (the parse, the dataset load, the host prep and the model's
    init), then driven an epoch at a time by the body of the CLI's
    per-epoch loop."""

    BIG = 1 << 62

    def __init__(self, cell: Cell, graph, seed: int, device: str,
                 workdir: str, sink):
        from benchmark import graphs
        from h2gcn_tpu_torch import run_experiments

        self.run_experiments = run_experiments
        path = os.path.join(workdir, "graph.npz")
        graphs.write_sparsegraph(graph, path)
        argv = [cell.config["model"], "sparsegraph", "--dataset", "graph",
                "--dataset_path", workdir, "--setting", "exist",
                "--epochs", "0", "--device", device,
                "--random_seed", str(program_seed(seed)),
                "--checkpoint_dir", os.path.join(workdir, "ckpt")]
        with contextlib.redirect_stdout(sink):
            self.args = run_experiments.main(argv + cell.config["cli"])
        os.remove(path)
        self.args.epochs = self.BIG
        self.args.current_epoch = 0
        self.objects = self.args.objects
        self.tensors = self.objects["tensors"]
        self.model = self.objects["model"]
        self.optimizer = self.objects["optimizer"]
        self.device = self.tensors["y_train"].device
        self.sink = sink

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def train_and_eval(self, label=None, step_sync=False):
        """The epoch body up to its sync: pre-epoch callbacks, the train
        step, the eval step. ``label`` names each part for the profiler;
        ``step_sync`` also syncs after the train step and returns its
        seconds."""
        a, o = self.args, self.objects
        a.current_epoch += 1
        for f in o["pre_epoch_callbacks"]:
            f(a.current_epoch, a)
        o["epoch_stats"] = {}
        t0 = time.perf_counter()
        with label("train_step"):
            o["epoch_stats"].update(o["train_step"](**self.tensors))
        t_train = None
        if step_sync:
            self.sync()
            t_train = time.perf_counter() - t0
        with label("test_step"):
            o["epoch_stats"].update(o["test_step"](**self.tensors))
        with label("sync"):
            self.sync()
        return t_train

    def post_epoch(self, label):
        a, o = self.args, self.objects
        with label("post_epoch"), contextlib.redirect_stdout(self.sink):
            for f in o["post_epoch_callbacks"]:
                f(a.current_epoch, a)
        if a.epochs != self.BIG:
            raise RuntimeError(f"the program stopped early at epoch "
                               f"{a.current_epoch}")
        return math.isfinite(float(o["epoch_stats"]["train_loss"]))

    def launches(self) -> int:
        return sum(self.run_experiments.kernel_launches().values())

    def params(self) -> dict:
        return dict(self.model.named_parameters())


def _no_label(name):
    return contextlib.nullcontext()


def checked_steps(prog: Program) -> dict:
    """The first :data:`CHECK_STEPS` epochs through the window's own call,
    with the readings the comparison needs: each step's training and
    validation loss, each leaf's first gradient (from the optimizer's
    first moment after one step, ``m = (1 - b1) g``) and its change over
    the steps."""
    import torch

    start = {k: v.detach().clone() for k, v in prog.params().items()}
    out = {"loss": [], "eval_loss": [], "grad1": {}, "delta3": {}}
    failed = 0
    for step in range(CHECK_STEPS):
        prog.train_and_eval(_no_label)
        stats = prog.objects["epoch_stats"]
        out["loss"].append(float(stats["train_loss"]))
        out["eval_loss"].append(float(stats["val_loss"]))
        if step == 0:
            b1 = prog.optimizer.param_groups[0]["b1"]
            for k, p in prog.params().items():
                st = prog.optimizer.state[p]
                m = st.get("m", st.get("exp_avg"))
                # no first moment: the optimizer took no step
                out["grad1"][k] = (math.nan if m is None
                                   else float(m.norm()) / (1.0 - b1))
        failed += not prog.post_epoch(_no_label)
    with torch.no_grad():
        out["delta3"] = {k: float((v.detach() - start[k]).norm())
                         for k, v in prog.params().items()}
    out["failed"] = failed
    return out


def reference_readings(cell: Cell, graph, seed: int, device,
                       precision="highest", fault=None) -> dict:
    """The plain reference's readings of the same three steps."""
    from benchmark import reference

    inputs = reference.Inputs(graph, device, fault=fault)
    model = cell.reference.Model(cell.config, graph, inputs, precision)
    params = model.init_params(program_seed(seed))
    lr = float(cell.config["cli"][cell.config["cli"].index("--lr") + 1])
    return reference.follow(model, inputs, params, lr, program_seed(seed),
                            CHECK_STEPS)


def p95(times) -> float:
    """The 95th percentile of all ``times``: the nearest-rank value, the
    smallest with at least 95% of them at or below it."""
    ranked = sorted(times)
    return ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]


def _window(prog: Program, seconds: float):
    """Epochs until ``seconds`` have passed; each timed from the previous
    epoch's sync to its own."""
    times, failed = [], 0
    t0 = last = time.perf_counter()
    while True:
        prog.train_and_eval(_no_label)
        now = time.perf_counter()
        times.append(now - last)
        last = now
        failed += not prog.post_epoch(_no_label)
        if now - t0 >= seconds:
            return t0, times, last - t0, failed


def _traced(prog: Program, cell: Cell, graph, seconds: float, workdir: str):
    """The per-layer stretches: epochs without the profiler (a sync an
    epoch: epoch time and launches), epochs with a sync a step (step
    times), then a short profiled stretch."""
    import torch

    run = types.SimpleNamespace(cell=cell, graph=graph, program=prog,
                                config=cell.config, traffic=cell.traffic,
                                reference=cell.reference, failed=0)
    l0 = prog.launches()
    t0, times, span, failed = _window(prog, seconds * STRETCH_SHARE)
    run.epochs = len(times)
    run.epoch_s = span / len(times)
    run.launches_per_epoch = (prog.launches() - l0) / len(times)
    run.failed += failed
    run.train_s, run.eval_s = [], []
    t_end = time.perf_counter() + seconds * STEPS_SHARE
    while True:
        t0 = time.perf_counter()
        run.train_s.append(prog.train_and_eval(_no_label, step_sync=True))
        run.eval_s.append(time.perf_counter() - t0 - run.train_s[-1])
        run.failed += not prog.post_epoch(_no_label)
        if time.perf_counter() >= t_end:
            break
    n_prof = int(min(PROFILE_MAX, max(PROFILE_MIN,
                                      round(PROFILE_S / run.epoch_s))))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    label = torch.profiler.record_function
    with torch.profiler.profile(activities=acts) as prof:
        with label("bench_window"):
            for _ in range(n_prof):
                prog.train_and_eval(label)
                run.failed += not prog.post_epoch(label)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    from benchmark import trace

    run.trace = trace.summarize(load_json(Path(path)))
    os.remove(path)
    run.attempted = run.epochs + len(run.train_s) + n_prof
    return run


def _device_info(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", cell: Cell = None,
             traffic: dict = None, hooks=None) -> dict:
    """One run of ``workload``; returns the result line's object. ``cell``
    and ``traffic`` let a test run a cell's code at a small
    size on the CPU; ``hooks(prog)`` lets a test break the program."""
    import torch

    from benchmark import checks, graphs

    cell = cell or Cell(workload)
    if device == "cuda":
        want = cell.cell["chips"]
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < want:
            raise NoDevice(f"the cell needs {want} CUDA device(s); "
                           f"this machine has {have}")
    graph = graphs.generate(traffic or cell.traffic, seed)
    with tempfile.TemporaryDirectory(prefix="bench_") as workdir, \
            open(os.devnull, "w") as sink:
        prog = Program(cell, graph, seed, device, workdir, sink)
        if hooks is not None:
            hooks(prog)
        prog_read = checked_steps(prog)
        for _ in range(WARMUP_EPOCHS):
            prog.train_and_eval(_no_label)
            prog.post_epoch(_no_label)
        result = {"correct": False, "attempted": 0, "failed": 0,
                  "metrics": {}}
        if not trace:
            t0, times, span, failed = _window(prog, seconds)
            setup_s = t0 - t_start
            values = {
                "epoch_ms": 1e3 * span / len(times),
                "epoch_ms_p95": 1e3 * p95(times),
                "setup_s": setup_s,
            }
            info = _device_info(device, cell.cell["chips"])
            values["peak_mem_gib"] = info["memory_peak_bytes"] / 2 ** 30
            result["attempted"], result["failed"] = len(times), failed
            for m in cell.metrics(False):
                # a dotted name is its base quantity in the cells it lists
                value = values[m["name"].split(".")[0]]
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        else:
            run = _traced(prog, cell, graph, seconds, workdir)
            for m in cell.metrics(True):
                reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                     "bench_metric_" + m["name"].replace(
                                         ".", "_"))
                value = reader.read(run)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            info = _device_info(device, cell.cell["chips"])
            info["busy_s"] = run.trace["busy_s"]
            info["window_s"] = run.trace["window_s"]
            result["attempted"], result["failed"] = run.attempted, run.failed
            result["breakdown"] = {"device_ops": run.trace["device_ops"],
                                   "idle_gaps": run.trace["idle_gaps"]}
            del run
        result["device"] = info
        result["failed"] += prog_read.pop("failed")
        del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, graph, seed, torch.device(device))
    try:
        values = checks.compare(prog_read, ref)
    except ValueError as err:
        print(f"comparison failed: {err}", file=sys.stderr)
        values = {k: math.inf for k in checks.NAMES}
    result["correct"] = checks.verdict(values, cell.limits)
    shown = cell.limits or values
    result["checks"] = {k: {"value": values[k], "limit": cell.limits.get(k)}
                        for k in shown}
    return result

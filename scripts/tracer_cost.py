"""The set-up account of one benchmark cell and the cost of the program's
tracer, in one process on the card.

    python3 scripts/tracer_cost.py --workload <cell> --seed <n> \
        [--rounds 6] [--epochs 100] [--graph_dir DIR] [--device cpu]

Prints JSON lines. ``setup``: the seconds from the process's start to the
first timed epoch, in the order the benchmark's run spends them (imports,
the CUDA context, the graph's generation, the CLI's ``main`` with the
program's ``setup.*`` spans inside it, the three checked and five warm-up
epochs, which load the kernel library: ``setup.library``). ``cost``: the
epoch time with the tracer off and on, ``--rounds`` rounds of
``--epochs`` epochs each, off then on, a sync an epoch. ``spans``: each
span's count, host ms and self ms an epoch over the traced epochs, and the
counters' change an epoch. ``--graph_dir`` also writes the cell's graph as
``DIR/graph.npz``, for a run of the CLI on it. ``--device cpu`` runs the
program's plain versions (no CUDA context).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _epochs(prog, n):
    """``n`` epochs through the harness's epoch body, each from the
    previous epoch's sync to its own: their seconds."""
    from benchmark import harness

    times, last = [], time.perf_counter()
    for _ in range(n):
        prog.train_and_eval(harness._no_label)
        now = time.perf_counter()
        times.append(now - last)
        last = now
        prog.post_epoch(harness._no_label)
    return times


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--graph_dir", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = p.parse_args(argv)

    marks = {}
    t = time.perf_counter()
    import torch

    from benchmark import graphs, harness
    from h2gcn_tpu_torch import tracing
    marks["imports_s"] = time.perf_counter() - t
    if a.device == "cuda":
        t = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        marks["cuda_context_s"] = time.perf_counter() - t
    cell = harness.Cell(a.workload)
    t = time.perf_counter()
    graph = graphs.generate(cell.traffic, a.seed)
    marks["graph_s"] = time.perf_counter() - t
    if a.graph_dir:
        os.makedirs(a.graph_dir, exist_ok=True)
        graphs.write_sparsegraph(graph, os.path.join(a.graph_dir,
                                                     "graph.npz"))
    with tempfile.TemporaryDirectory(prefix="bench_") as workdir, \
            open(os.devnull, "w") as sink:
        t = time.perf_counter()
        prog = harness.Program(cell, graph, a.seed, a.device, workdir,
                               sink)
        marks["main_s"] = time.perf_counter() - t
        store = prog.objects["spans"]
        t = time.perf_counter()
        harness.checked_steps(prog)
        _epochs(prog, harness.WARMUP_EPOCHS)
        marks["checked_and_warmup_s"] = time.perf_counter() - t
        marks["setup_s"] = time.perf_counter() - T_START
        marks["spans_s"] = {r.name: r.seconds for r in store.records
                            if r.name.startswith("setup.")}
        print(json.dumps({"setup": marks, "workload": a.workload,
                          "seed": a.seed}), flush=True)

        off, on = [], []
        for _ in range(a.rounds):
            off.append(1e3 * statistics.median(_epochs(prog, a.epochs)))
            n0, c0 = len(store.records), tracing.counters()
            was = tracing.enable()
            try:
                on.append(1e3 * statistics.median(_epochs(prog, a.epochs)))
            finally:
                tracing.enable(was)
        ratio = [b / o for o, b in zip(off, on)]
        print(json.dumps({"cost": {
            "off_ms": off, "on_ms": on, "on_over_off": ratio,
            "median_on_over_off": statistics.median(ratio)}}), flush=True)
        epochs = a.epochs
        rows = store.summary(store.records[n0:])
        print(json.dumps({"spans": {
            k: {"count": v["count"] / epochs, "ms": 1e3 * v["s"] / epochs,
                "self_ms": 1e3 * v["self_s"] / epochs}
            for k, v in rows.items()},
            "counters": {k: (v - c0.get(k, 0)) / epochs
                         for k, v in tracing.counters().items()}}),
            flush=True)


if __name__ == "__main__":
    main()

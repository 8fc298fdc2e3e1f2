"""The readings the limits are set from, for one cell at its own size:
per seed, the program's numbers against the plain reference (its first
three steps, as a run takes them), and the control's and the faults'
numbers against the same reference:

- ``control``: the reference in the nearest precision below the
  configuration's (TF32 operands for float32 with TF32 off);
- ``half_batch``: half of the training nodes left out, the mean over the
  rest;
- ``answer``: one training node's logits altered where they are made;
- a step that leaves the state unchanged reads 1 on ``delta3`` by its
  definition and needs no run.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed. Not part of a benchmark run.
"""

import argparse
import gc
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import checks, graphs, harness  # noqa: E402


def readings(cell, seed: int, device: str = "cuda") -> dict:
    import torch

    graph = graphs.generate(cell.traffic, seed)
    with tempfile.TemporaryDirectory(prefix="bench_") as workdir, \
            open(os.devnull, "w") as sink:
        prog = harness.Program(cell, graph, seed, device, workdir, sink)
        prog_read = harness.checked_steps(prog)
        prog_read.pop("failed")
        del prog
    gc.collect()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference_readings(cell, graph, seed, dev)
    out = {"seed": seed, "program": checks.compare(prog_read, ref),
           "worst": {part: checks.worst_leaves(prog_read, ref, part, k=64)
                     for part in ("grad1", "delta3")}}
    for name, kw in (("control", dict(precision="tf32")),
                     ("half_batch", dict(fault="half_batch")),
                     ("answer", dict(fault="answer"))):
        other = harness.reference_readings(cell, graph, seed, dev, **kw)
        out[name] = checks.compare(other, ref)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = harness.Cell(a.workload)
    for seed in a.seeds:
        print(json.dumps(readings(cell, seed)), flush=True)


if __name__ == "__main__":
    main()

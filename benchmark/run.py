"""The benchmark of ``h2gcn_tpu_torch`` on one NVIDIA H100: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit,
also the last lines of standard error). Exits non-zero with no result line
where the machine lacks the cards the cell asks for, or where JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), t_start=T_START)
    except harness.NoDevice as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

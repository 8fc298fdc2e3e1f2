"""The benchmark's own tests: CPU tests at small sizes, and tests that
need a CUDA card, which take the ``cuda`` fixture and skip without one.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small graphs of each traffic's kind, for the CPU runs
TINY = {
    "h2gcn2.squirrel": dict(
        nodes=300, edges=2000, features=50, feature_kind="binary",
        feature_nnz_per_row=5, classes=5, degree_exponent=0.6, graph_seed=0,
        split={"kind": "per_class", "train": 0.48, "val": 0.32}),
    "gat.arxiv-year": dict(
        nodes=400, edges=2000, features=16, feature_kind="uniform",
        classes=5, degree_exponent=0.6, graph_seed=0,
        split={"kind": "random", "train": 0.5, "val": 0.25}),
}


def tiny_cell(workload):
    """The cell with its CLI as it runs at small sizes: GAT's ``auto``
    payload picks the BSR mask on a small graph, so the gather payload,
    which ``auto`` picks at the cell's size, is named."""
    from benchmark import harness

    cell = harness.Cell(workload)
    cell.config = dict(cell.config)
    cell.config["cli"] = ["gather" if t == "auto" and workload.startswith(
        "gat") else t for t in cell.config["cli"]]
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the cell runs on the card)")
    return torch.device("cuda")

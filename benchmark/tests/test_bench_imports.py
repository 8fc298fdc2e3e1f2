"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``h2gcn_tpu`` (whole names: ``h2gcn_tpu_torch``
is the program), and the reference nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
REFERENCE = [BENCH / "reference.py", BENCH / "checks.py",
             BENCH / "graphs.py"] + sorted((BENCH / "configs").glob("*.py"))


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "h2gcn_tpu_torch_x", object())
    assert "h2gcn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "h2gcn_tpu.sparse", object())
    assert "h2gcn_tpu" in harness.forbidden_modules()


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not _top_imports(path) & {"jax", "jaxlib", "flax",
                                         "h2gcn_tpu"}, path


def test_reference_sources_import_no_program():
    for path in REFERENCE:
        assert "h2gcn_tpu_torch" not in _top_imports(path), path


_RUN = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests.conftest import TINY, tiny_cell
w = "gat.arxiv-year"
harness.run_cell(w, 3, 0.2, {trace}, t_start=time.perf_counter(),
                 device="cpu", cell=tiny_cell(w), traffic=TINY[w])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_REF = """
import sys, torch
sys.path.insert(0, {root!r})
from benchmark import graphs, harness
from benchmark.tests.conftest import TINY
for w in TINY:
    cell = harness.Cell(w)
    g = graphs.generate(TINY[w], 3)
    harness.reference_readings(cell, g, 3, torch.device("cpu"))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    for trace in (False, True):
        mods = _loaded(_RUN.format(root=str(ROOT), trace=trace))
        assert "h2gcn_tpu_torch" in mods
        assert not mods & {"jax", "jaxlib", "flax", "h2gcn_tpu"}


def test_the_reference_loads_no_program():
    mods = _loaded(_REF.format(root=str(ROOT)))
    assert not mods & {"jax", "jaxlib", "flax", "h2gcn_tpu",
                       "h2gcn_tpu_torch"}

"""Rules of the PyTorch port: it never imports JAX or the JAX package, its
entry point does not fall back to the CPU, and chip_smoke.py fails without
a GPU before it prints any result."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import h2gcn_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "h2gcn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "h2gcn_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        h2gcn_tpu_torch.__path__, prefix="h2gcn_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for mod in ("sparse.gscatter", "sparse.bsr_spmm", "sparse.attention",
                "sparse.attention_coo", "sparse.attention_gather",
                "sparse.cootile", "models.GAT", "native", "entry",
                "parallel.mesh", "parallel._collectives", "parallel.dist",
                "parallel.train", "parallel.attention", "parallel.multihost",
                "parallel.dryrun", "parallel.spgemm",
                "nn.blocked"):
        assert f"h2gcn_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_import_in_the_source():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_point_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: --device cuda is valid here")
    from h2gcn_tpu_torch import run_experiments

    with pytest.raises(RuntimeError, match="--device cpu"):
        run_experiments.main(["H2GCN", "planetoid", "--dataset", "x",
                              "--dataset_path", "/nonexistent"])


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (tmp_path, str(REPO / "chip_smoke.py"))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert proc.stdout == ""  # no result line of any kind

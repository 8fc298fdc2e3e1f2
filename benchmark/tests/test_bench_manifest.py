"""``BENCHMARK.json`` and the files it names: the allowed characters,
the keys, the data files found by name, the check's time budget."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(M["command"]) <= 32
    assert all(LINE.match(w) for w in M["command"])


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                  "higher")
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads"):
                    assert LINE.match(e[key])


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_find_their_files():
    configs = {c["name"]: c for c in M["configs"]}
    assert len(M["workloads"]) <= 24
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        c = configs[w["config"]]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert (BENCH / "configs" / f"{w['config']}.py").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert lim["limits"]
        per_layer = [m for m in M["per_layer"] if w["name"] in m["workloads"]]
        assert per_layer


def test_full_check_fits():
    runs = 2 + 14 * 24
    total = runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*")
    if p.is_file() and "__pycache__" not in p.parts))
def test_file_names(path):
    assert re.match(r"^[A-Za-z0-9_./-]+$", path)

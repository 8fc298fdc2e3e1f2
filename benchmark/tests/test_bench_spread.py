"""``spread.py``'s readings of the machine, its window summary and the rule
that sets an end-to-end bound from two sets of runs."""

import pytest

from benchmark import spread


@pytest.mark.parametrize("text, cpus", [
    ("0-25,52-77", list(range(26)) + list(range(52, 78))),
    ("3", [3]), ("0,2-3\n", [0, 2, 3]), ("", [])])
def test_parse_cpulist(text, cpus):
    assert spread.parse_cpulist(text) == cpus


@pytest.mark.parametrize("node, want", [("1", 1), ("0", 0), ("-1", None),
                                        (None, None)])
def test_gpu_numa_node(tmp_path, node, want):
    dev = tmp_path / "bus/pci/devices/0000:19:00.0"
    dev.mkdir(parents=True)
    if node is not None:
        (dev / "numa_node").write_text(node + "\n")
    assert spread.gpu_numa_node("00000000:19:00.0", tmp_path) == want
    assert spread.gpu_numa_node("[N/A]", tmp_path) is None


def test_numa_nodes(tmp_path):
    assert spread.numa_nodes(tmp_path) == {}
    for n, cpus in ((0, "0-25,52-77"), (1, "26-51,78-103")):
        d = tmp_path / f"devices/system/node/node{n}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpus)
    nodes = spread.numa_nodes(tmp_path)
    assert sorted(nodes) == [0, 1] and len(nodes[1]) == 52
    assert nodes[1][0] == 26 and nodes[1][-1] == 103


def test_window_summary():
    times = [0.004] * 250 + [0.008] * 125          # 1 s fast, then 1 s slow
    events = [(99.0, "start", 0), (99.5, "stop", 0),       # before t0
              (100.5, "start", 2), (100.52, "stop", 2),
              (101.2, "start", 0), (101.2001, "stop", 0)]
    w = spread.window_summary(100.0, 102.0, times, events)
    assert w["epochs"] == 375
    assert w["epoch_ms"] == pytest.approx(2000 / 375)
    assert w["p95_ms"] == pytest.approx(8.0)
    assert w["first_s_ms"] == pytest.approx(4.0)
    assert w["last_s_ms"] == pytest.approx(8.0)
    assert w["gc"]["2"]["n"] == 1 and w["gc"]["2"]["s"] == pytest.approx(
        0.02)
    assert w["gc"]["0"]["n"] == 1


@pytest.mark.parametrize("x, want", [(0.1125, 0.12), (0.04, 0.04),
                                     (0.0401, 0.041), (1.08, 1.1),
                                     (0.00317, 0.0032)])
def test_round_up(x, want):
    assert spread.round_up(x) == want


def test_spread():
    # statistics.quantiles' exclusive quartiles of six: positions 1.75
    # and 5.25 of the sorted runs
    s = spread.spread([5.0, 4.0, 6.0, 4.5, 10.0, 5.5])
    assert s["median"] == 5.25
    assert s["iqr"] == pytest.approx((7.0 - 4.375) / 5.25)
    assert s["range"] == pytest.approx(6.0 / 5.25)


@pytest.mark.parametrize("iqr, rng, want", [
    # spreads of squirrel's host-paced epoch (0.22, 0.24): past the cap
    (0.22, 0.5, 0.25), (0.24, 0.3, 0.25),
    # spreads of GAT's host-paced epoch (0.025, 0.11)
    (0.025, 0.05, 0.12), (0.11, 0.2, 0.25),
    # the range term wins where one run lies far out
    (0.01, 0.05, 0.1),
    # a device-paced epoch (0.99%): 4.5 x, rounded up
    (0.0099, 0.02, 0.045),
    # never under 1%
    (0.0005, 0.001, 0.01)])
def test_bound_rule(iqr, rng, want):
    assert spread.rule(iqr, rng) == want


def test_bound_takes_the_wider_set():
    calm = [10.0, 10.1, 9.9, 10.0, 10.05, 9.95]
    wide = [10.0, 11.0, 9.0, 10.0, 10.5, 9.5]
    assert spread.bound([calm, wide]) == spread.bound([wide]) > \
        spread.bound([calm])


def _row(index, epoch, loop):
    return {"index": index, "seed": 7, "pid": 100,
            "metrics": {"epoch_device_ms": 1.9, "setup_s": 20.0 + index},
            "window": {"epoch_ms": epoch, "p95_ms": 1.3 * epoch,
                       "first_s_ms": epoch, "last_s_ms": epoch,
                       "deciles_ms": [epoch] * 9,
                       "gc": {"0": {"n": 2, "s": 1e-4}}},
            "threads": {"100": {"name": "python3", "cpu_s": 7.0},
                        "101": {"name": "pt_autograd_0", "cpu_s": 2.5}},
            "host_loop_us": {"median": loop},
            "smi": {"sm_mhz": 1980.0, "sm_mhz_min": 1980.0,
                    "power_w": 230.0}}


def test_report_names_the_factor_that_tracks():
    rows = [_row(i, e, g) for i, (e, g) in enumerate(
        [(5.0, 900), (6.0, 1080), (7.0, 1260), (5.5, 990)])]
    rows.append({"index": 4, "seed": 8, "rc": 1})      # no result
    text = spread.report(rows)
    assert text.count("\n| ") == 5                      # head rule + 4 rows
    assert "corr(epoch, host_loop_us) = 1.000" in text
    assert "corr(epoch, sm_mhz) = —" in text            # constant clock
    assert "window epoch_ms: median 5.75" in text
    assert "epoch_device_ms: median 1.9, IQR/median 0.0000" in text

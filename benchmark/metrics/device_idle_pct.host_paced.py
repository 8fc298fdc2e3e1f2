"""``device_idle_pct`` in the cells whose epochs the host paces (they report
``epoch_ms.host_paced``): the same reader."""

from pathlib import Path

from benchmark import harness

read = harness.load_module(Path(__file__).with_name("device_idle_pct.py"),
                           "bench_metric_device_idle_pct").read

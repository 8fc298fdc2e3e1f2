"""``readbacks_per_epoch`` in the cells whose epochs the host paces (they
report ``epoch_ms.host_paced``): the same reader."""

from pathlib import Path

from benchmark import harness

read = harness.load_module(Path(__file__).with_name("readbacks_per_epoch.py"),
                           "bench_metric_readbacks_per_epoch").read

"""``epoch_mfu`` in the cells whose epochs the host paces (they report
``epoch_ms.host_paced``): the same reader."""

from pathlib import Path

from benchmark import harness

read = harness.load_module(Path(__file__).with_name("epoch_mfu.py"),
                           "bench_metric_epoch_mfu").read

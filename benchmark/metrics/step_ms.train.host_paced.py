"""``step_ms.train`` in the cells whose epochs the host paces (they report
``epoch_ms.host_paced``): the same reader."""

from pathlib import Path

from benchmark import harness

read = harness.load_module(Path(__file__).with_name("step_ms.train.py"),
                           "bench_metric_step_ms_train").read

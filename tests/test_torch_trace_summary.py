"""trace_summary reads a chrome trace: the device's busy time is the union
of its kernel and copy intervals, and the host's calls are summed by
name."""

import json

import pytest

from h2gcn_tpu_torch import trace_summary


def _trace():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 90, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0, "dur": 3},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 4},
        {"ph": "i", "cat": "marker", "name": "ignored", "ts": 50},
    ]
    return {"traceEvents": ev}


def test_summary_counts_busy_time_once():
    out = trace_summary.summarize(_trace(), epochs=2, top=5)
    assert out["window_ms"] == pytest.approx(0.1)
    assert out["device_busy_ms"] == pytest.approx(0.030)  # 15 + 5 + 10 us
    assert out["device_idle_share"] == pytest.approx(0.7)
    assert out["kernel_launches"] == 3 and out["copies"] == 1
    assert out["kernels"][0] == {"name": "k1", "count": 2, "ms": 0.02}
    assert out["runtime_calls"][0]["name"] == "cudaLaunchKernel"
    assert out["host_ops_inclusive"][0]["count"] == 1
    assert out["per_epoch"]["kernel_launches"] == 1.5


def test_cli_prints_one_json_line(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace()))
    trace_summary.main([str(path), "--epochs", "1"])
    out = json.loads(capsys.readouterr().out)
    assert out["per_epoch"]["copies"] == 1
    with pytest.raises(ValueError, match="no complete events"):
        trace_summary.summarize({"traceEvents": []})

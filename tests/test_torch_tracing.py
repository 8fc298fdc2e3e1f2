"""The program's spans and counters (``h2gcn_tpu_torch.tracing``): the off
path records nothing and opens no profiler range; on, spans nest per
thread with the right self time; a CLI run records the spans and
readbacks an epoch should have; a profiler trace holds every span as an
annotation of the same name; the launch counters and ``prep_seconds``
keep what they gave before."""

import json
import threading
import time

import pytest
import torch

import chip_smoke
from h2gcn_tpu_torch import run_experiments, tracing

WRAPPERS = ("gscatter_spmm", "bsr_spmm", "cootile_spmm", "gat_fwd_stats",
            "gat_bwd_row", "gat_bwd_col", "coo_fwd_stats", "coo_bwd_row",
            "coo_bwd_col", "gscatter_weighted")


@pytest.fixture
def traced():
    """The tracer on, in a fresh store; off again afterwards."""
    store = tracing.new_store()
    was = tracing.enable()
    yield store
    tracing.enable(was)


@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sparsegraph"))
    chip_smoke.write_sparsegraph(
        path, "g", chip_smoke.build_graph(n=300, m_edges=1500, seed=2),
        seed=2, n_feat=40, feats_per_row=4, n_classes=4)
    return path


def _main(graph_dir, tmp_path, model, *extra):
    return run_experiments.main([
        model, "sparsegraph", "--dataset", "g", "--dataset_path", graph_dir,
        "--device", "cpu", "--random_seed", "7",
        "--checkpoint_dir", str(tmp_path / "ckpt"), *extra])


def _epochs(args, n):
    """``n`` epochs of the CLI's loop body (no sync: the CPU); the counter
    ``readbacks`` after each."""
    o, reads = args.objects, []
    for _ in range(n):
        args.current_epoch += 1
        o["epoch_stats"] = {}
        o["epoch_stats"].update(o["train_step"](**o["tensors"]))
        o["epoch_stats"].update(o["test_step"](**o["tensors"]))
        for f in o["post_epoch_callbacks"]:
            f(args.current_epoch, args)
        reads.append(tracing.counter("readbacks"))
    return reads


def _seconds(store, name):
    return sum(r.seconds for r in store.records if r.name == name)


def _no_range(*args, **kwargs):
    raise AssertionError("record_function was called")


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    store = tracing.new_store()
    assert not tracing.enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("step.train"):
            with tracing.span("spmm", backend="segment", F=4):
                pass
        tracing.traced("step.eval")(lambda: None)()
    assert store.records == [] and store.dropped == 0
    assert tracing.span("spmm") is tracing.span("step.eval")


def test_on_spans_nest_per_thread(traced):
    inner = {}

    def worker():
        with tracing.span("attn.backward"):
            time.sleep(0.002)
        inner["stack"] = list(tracing._stack())

    with tracing.span("step.train"):
        with tracing.span("step.train.forward"):
            with tracing.span("spmm", F=8):
                time.sleep(0.002)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with tracing.span("step.train.optimizer"):
            time.sleep(0.001)
    recs = {r.name: r for r in traced.records}
    assert set(recs) == {"step.train", "step.train.forward", "spmm",
                         "attn.backward", "step.train.optimizer"}
    assert recs["spmm"].parent is recs["step.train.forward"]
    assert recs["step.train.forward"].parent is recs["step.train"]
    assert recs["step.train.optimizer"].parent is recs["step.train"]
    assert recs["step.train"].parent is None
    # another thread starts its own stack
    assert recs["attn.backward"].parent is None and inner["stack"] == []
    assert recs["attn.backward"].thread != recs["spmm"].thread
    assert recs["spmm"].attrs == {"F": 8}
    for r in traced.records:
        assert 0 < r.start < r.end
        if r.parent is not None:
            assert r.parent.start <= r.start and r.end <= r.parent.end
    s = traced.summary()
    top = recs["step.train"]
    assert s["step.train"]["self_s"] == pytest.approx(
        top.seconds - recs["step.train.forward"].seconds
        - recs["step.train.optimizer"].seconds)
    assert s["step.train.forward"]["self_s"] == pytest.approx(
        recs["step.train.forward"].seconds - recs["spmm"].seconds)
    assert s["spmm"] == {"count": 1, "s": recs["spmm"].seconds,
                         "self_s": recs["spmm"].seconds, "launches": 0}
    assert tracing._stack() == []


def test_spans_count_launches_and_the_store_caps(traced):
    with tracing.span("spmm"):
        tracing.launched("gscatter_spmm")
        tracing.launched("gscatter_spmm")
    assert traced.records[-1].launches == 2
    small = tracing.Store(cap=2)
    for _ in range(5):
        small.add(tracing.Record("spmm", {}))
    assert len(small.records) == 2 and small.dropped == 3


def test_phase_is_recorded_whatever_the_switch():
    store = tracing.new_store()
    assert not tracing.enabled()
    with tracing.phase("setup.load") as ph:
        time.sleep(0.001)
    assert [r.name for r in store.records] == ["setup.load"]
    assert ph.seconds == _seconds(store, "setup.load") >= 0.001


def test_kernel_launches_is_a_view_of_the_counters():
    """The ten wrappers' names, as ``fn.__name__`` gave them, and only
    those that launched."""
    before = run_experiments.kernel_launches()
    assert set(before) <= set(WRAPPERS)
    try:
        for i, name in enumerate(WRAPPERS):
            for _ in range(i):
                tracing.launched(name)
        want = {name: before.get(name, 0) + i
                for i, name in enumerate(WRAPPERS) if before.get(name, 0) + i}
        assert run_experiments.kernel_launches() == want
        assert {k: v for k, v in tracing.counters("launches.").items()
                if v} == {"launches." + k: v for k, v in want.items()}
    finally:
        # other tests of this process read the counters: take these back
        for i, name in enumerate(WRAPPERS):
            tracing.count("launches." + name, -i)
    assert run_experiments.kernel_launches() == before


def test_readback_counts_tensors_only():
    before = tracing.counter("readbacks")
    assert tracing.readback(torch.tensor(1.5)) == 1.5
    arr = tracing.readback(torch.arange(3.0))
    assert arr.tolist() == [0.0, 1.0, 2.0]
    assert tracing.readback(2) == 2.0 and isinstance(tracing.readback(2),
                                                     float)
    assert tracing.counter("readbacks") == before + 2


def test_prep_seconds_are_the_prep_spans(graph_dir, tmp_path):
    args = _main(graph_dir, tmp_path, "H2GCN", "--epochs", "0")
    store = args.objects["spans"]
    prep = args.objects["tensors"]["prep_seconds"]
    assert set(prep) == {"split", "reorder", "export"}
    for key, value in prep.items():
        assert value == _seconds(store, f"setup.prep.{key}") >= 0.0
    names = [r.name for r in store.records]
    for name in ("setup.load", "setup.prep.split", "setup.model_init"):
        assert names.count(name) == 1
    assert set(names) <= set(tracing.SPANS)


def test_cli_epochs_record_their_spans_and_readbacks(graph_dir, tmp_path,
                                                     traced):
    """H2GCN-2: 12 SpMMs an epoch (4 in each forward, train and eval, 4 in
    the backward), the train step's four parts, one eval step and one
    post-epoch callback; readbacks: the printer's 6 stats, the sliding
    mean's 1 and best-val's 2 (1 in the first epoch, with no best yet)."""
    tracing.enable(False)
    args = _main(graph_dir, tmp_path, "H2GCN", "--epochs", "0")
    store = args.objects["spans"]
    args.current_epoch = 0
    tracing.enable()
    n0 = len(store.records)
    r0 = tracing.counter("readbacks")
    reads = _epochs(args, 3)
    names = [r.name for r in store.records[n0:]]
    want = {"spmm": 12, "step.train": 1, "step.train.forward": 1,
            "step.train.loss": 1, "step.train.backward": 1,
            "step.train.optimizer": 1, "step.eval": 1, "epoch.post": 1}
    assert {k: names.count(k) / 3 for k in set(names)} == want
    assert [b - a for a, b in zip([r0] + reads, reads)] == [7, 9, 9]
    spmm = [r for r in store.records[n0:] if r.name == "spmm"]
    assert {r.attrs["direction"] for r in spmm} == {"forward", "backward"}
    assert {r.attrs["backend"] for r in spmm} == {"segment"}


def test_cli_gat_epochs_read_back_ten(graph_dir, tmp_path, traced):
    """GAT on the gather payload: the printer's 6, GAT's patience 2 and
    best-val's 2 (1 in the first epoch); one attention forward a layer."""
    tracing.enable(False)
    args = _main(graph_dir, tmp_path, "GAT", "--epochs", "0",
                 "--fused_attention", "--attn_impl", "gather",
                 "--attn_drop", "0.6")
    store = args.objects["spans"]
    assert _seconds(store, "setup.payload") > 0
    args.current_epoch = 0
    tracing.enable()
    n0 = len(store.records)
    r0 = tracing.counter("readbacks")
    reads = _epochs(args, 2)
    assert [b - a for a, b in zip([r0] + reads, reads)] == [8, 10]
    names = [r.name for r in store.records[n0:]]
    # 2 layers: forward in train and eval, backward in train
    assert names.count("attn.forward") == 2 * 2 * 2
    assert names.count("attn.backward") == 2 * 2
    assert names.count("step.train.optimizer") == 2


def test_timing_prints_the_spans(graph_dir, tmp_path, capsys):
    _main(graph_dir, tmp_path, "H2GCN", "--epochs", "3", "--timing")
    assert not tracing.enabled()  # on for the run only
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("===> Spans: ")][-1]
    spans = json.loads(line[len("===> Spans: "):])
    assert spans["step.train"]["count"] == 3
    # 12 an epoch and 4 in the post-train restore's eval
    assert spans["spmm"]["count"] == 3 * 12 + 4
    assert spans["step.train"]["s"] >= spans["step.train"]["self_s"] > 0


def test_profiler_trace_holds_every_span(graph_dir, tmp_path, traced):
    """Two epochs under torch.profiler with the tracer on: each in-memory
    span is a user_annotation of the same name, count and parent, and of
    the same duration within the cost of opening the range."""
    tracing.enable(False)
    args = _main(graph_dir, tmp_path, "H2GCN", "--epochs", "0")
    store = args.objects["spans"]
    args.current_epoch = 0
    _epochs(args, 1)  # warm
    tracing.enable()
    n0 = len(store.records)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _epochs(args, 2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"] in tracing.SPANS]
    recs = sorted(store.records[n0:], key=lambda r: r.start)
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in events] == [r.name for r in recs]

    def parent(e):
        inside = [p for p in events if p is not e
                  and p.get("tid") == e.get("tid")
                  and p["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        return max(inside, key=lambda p: p["ts"])["name"] if inside else None

    totals = {}
    for e, r in zip(events, recs):
        assert parent(e) == (r.parent.name if r.parent else None)
        # the range opens before the span's clock starts and closes after
        # it stops; a preempted process can widen one range by milliseconds
        dur_us = r.seconds * 1e6
        assert e["dur"] >= 0.99 * dur_us - 100, (r.name, e["dur"], dur_us)
        t = totals.setdefault(r.name, [0.0, 0.0])
        t[0] += e["dur"]
        t[1] += dur_us
    for name, (ann_us, span_us) in totals.items():
        assert ann_us == pytest.approx(span_us, rel=0.1, abs=2000), name

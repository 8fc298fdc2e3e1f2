"""The program's spans and counters: where its host time goes, and what it
counts.

A **span** names a stretch of the program's host time::

    with tracing.span("spmm", backend="gscatter", F=128):
        ...

Off (the default), :func:`span` checks one module flag and returns a
shared no-op context. On (:func:`enable`), each span is kept as a
:class:`Record` in the current :class:`Store`: its name, start and end on
``time.perf_counter_ns()``, its parent (the innermost span open on the
same thread: autograd runs a CUDA backward on a thread of its own), the
thread, the kernel launches made inside it and small attributes. While a
``torch.profiler`` records, an open span is also a ``record_function``
range of the same name, so it lands in the profiler's chrome trace beside
the device's kernels, on the profiler's clock (``trace_summary`` reads it
there). :func:`phase` opens a set-up span, recorded whatever the switch:
set-up runs once a run.

A **counter** (:func:`count`) is always on: one locked dict add.
``launches.<wrapper>`` counts each CUDA kernel wrapper's launches
(:func:`launched`), ``readbacks`` the epoch path's device-to-host
conversions (:func:`readback`), ``route.<backend>`` each matrix
``auto`` routes, ``gcnii.layers`` GCNII's layer forwards,
``gscatter.split_rows`` the rows that more than one of #1's work items sum
(counted where ``sparse/gscatter.py:row_schedule`` cuts the items, once a
payload: how often the kernel's combine of a row's pieces engages).

Every span name the program opens is a key of :data:`SPANS`, with what
reads it. Each CLI run (``run_experiments.main``) starts a fresh store
(:func:`new_store`) and hands it out as ``args.objects["spans"]``, so a
reader gets the set-up spans of the run it reads.
"""

from __future__ import annotations

import collections
import functools
import threading
import time

import torch

# every span the program opens: where, and what reads it
SPANS = {
    "step.train": "models/_runtime.py train: PERF.md section 5's epoch split",
    "step.train.forward": "the train step's forward: PERF.md section 5",
    "step.train.loss": "its loss with the L2 term: PERF.md section 5",
    "step.train.backward": "its backward: PERF.md section 5",
    "step.train.optimizer": "its optimizer step: optimizer_ms.host_paced",
    "step.eval": "models/_runtime.py evaluate: PERF.md section 5",
    "epoch.post": "the post-epoch callback: PERF.md section 5",
    "spmm": "sparse/matrix.py _SpMM, forward and backward: spmm_host_us",
    "gcnii.layer": "models/GCNII.py, a layer's forward around its spmm: "
                   "gcnii_layer_host_us",
    "attn.forward": "sparse/attention_gather.py, the gather payload: "
                    "PERF.md section 5",
    "attn.backward": "the same, backward: PERF.md section 5",
    "setup.load": "the sparsegraph loader: load_s",
    "setup.prep.split": "get_tensors' exact-hop split: prep_s",
    "setup.prep.reorder": "get_tensors' node reorder: prep_s",
    "setup.prep.export": "get_tensors' device export and tables: prep_s",
    "setup.payload": "GAT's attention support and payload: payload_s",
    "setup.library": "the kernel library's build or load: PERF.md section 5",
    "setup.model_init": "the parameters' draw and the optimizer: PERF.md "
                        "section 5",
}

# records a store keeps; past it a store drops records and counts them
CAP = 200_000

_on = False
_lock = threading.Lock()
_counts = collections.Counter()
_launch_total = 0
_tls = threading.local()


class Record:
    """One closed span: ``start`` and ``end`` in ns of
    ``time.perf_counter_ns()``, ``parent`` the enclosing :class:`Record` on
    the same thread (or None), ``launches`` the kernel launches counted
    while it was open."""

    __slots__ = ("name", "attrs", "parent", "thread", "start", "end",
                 "launches")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.parent = None
        self.thread = 0
        self.start = self.end = 0
        self.launches = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class Store:
    """The records of one run, in the order the spans closed, at most
    ``cap`` of them; ``dropped`` counts those past the cap."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records = []
        self.dropped = 0

    def add(self, record: Record) -> None:
        with _lock:
            if len(self.records) < self.cap:
                self.records.append(record)
            else:
                self.dropped += 1

    def summary(self, records=None) -> dict:
        """``{name: {"count", "s", "self_s", "launches"}}`` over
        ``records`` (default: all of this store's): the spans' host
        seconds, and those outside their child spans."""
        records = self.records if records is None else records
        child_s = collections.Counter()
        for r in records:
            if r.parent is not None:
                child_s[id(r.parent)] += r.seconds
        out = {}
        for r in records:
            row = out.setdefault(r.name, {"count": 0, "s": 0.0,
                                          "self_s": 0.0, "launches": 0})
            row["count"] += 1
            row["s"] += r.seconds
            row["self_s"] += r.seconds - child_s[id(r)]
            row["launches"] += r.launches
        return out


_store = Store()


def new_store() -> Store:
    """Start a fresh store of records (a new run) and return it."""
    global _store
    _store = Store()
    return _store


def enable(on: bool = True) -> bool:
    """Turn the spans on or off; returns the previous state."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    return _on


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class _Span:
    __slots__ = ("record", "_store", "_range", "_launches")

    def __init__(self, name, attrs):
        self.record = Record(name, attrs)
        self._range = None

    @property
    def seconds(self) -> float:
        return self.record.seconds

    def __enter__(self):
        r = self.record
        stack = _stack()
        r.parent = stack[-1] if stack else None
        r.thread = threading.get_ident()
        stack.append(r)
        self._store = _store
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(r.name)
            self._range.__enter__()
        self._launches = _launch_total
        r.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        r = self.record
        r.end = time.perf_counter_ns()
        r.launches = _launch_total - self._launches
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        self._store.add(r)
        return False


class _Off:
    """The shared no-op span of the off path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` (a key of :data:`SPANS`) with ``attrs``;
    recorded only while the tracer is on."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def phase(name: str) -> _Span:
    """A set-up span, recorded whatever the switch; its ``seconds`` are
    read once it has closed."""
    return _Span(name, {})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] += n


def launched(wrapper: str) -> None:
    """Count one kernel launch of ``wrapper`` (``launches.<wrapper>``)."""
    global _launch_total
    with _lock:
        _counts["launches." + wrapper] += 1
        _launch_total += 1


def counter(name: str) -> int:
    return _counts[name]


def counters(prefix: str = "") -> dict:
    """A copy of the counters whose names start with ``prefix``."""
    with _lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def readback(value):
    """``value`` on the host, counted under ``readbacks`` when it is a
    tensor (on the card each such conversion waits for the device): a
    0-d tensor or a number as a float, any other tensor as a numpy
    array."""
    if isinstance(value, torch.Tensor):
        count("readbacks")
        if value.dim():
            return value.cpu().numpy()
    return float(value)

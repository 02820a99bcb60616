"""The port's tracing hooks on the CPU: ``trace_span`` logs its wall time and
annotates the torch.profiler timeline, ``profile_to`` writes a Chrome trace
that holds the spans recorded inside it, and ``setup_logging`` reads
$GRAPE_LOG as the JAX package's does. The span recorder: nesting, self
times, recording only inside a capture (on any thread), its bounded buffer,
the spans of a database search, and the always-on counters on /metrics.
The device window's CUDA events are held on the card in
``tests/test_torch_cuda.py``.
"""

import gc
import glob
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

from grape_vector_db_tpu.utils import tracing as jax_tracing
from grape_vector_db_tpu_torch import Document, VectorDatabase, VectorDbConfig
from grape_vector_db_tpu_torch.utils import tracing


def test_trace_span_logs_and_annotates(caplog):
    with caplog.at_level(logging.DEBUG, logger="grape_vector_db_tpu_torch"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing.trace_span("gvdb.test_span"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "gvdb.test_span" for e in prof.key_averages())
    msgs = [r.getMessage() for r in caplog.records if r.name == "grape_vector_db_tpu_torch"]
    assert any(m.startswith("span gvdb.test_span took ") and m.endswith(" ms") for m in msgs)


def test_trace_span_threshold_and_errors(caplog):
    with caplog.at_level(logging.DEBUG, logger="grape_vector_db_tpu_torch"):
        with tracing.trace_span("gvdb.quiet", log_threshold_ms=1e9):
            pass
        with pytest.raises(ValueError):
            with tracing.trace_span("gvdb.failing"):
                raise ValueError("inside the span")
    msgs = [r.getMessage() for r in caplog.records]
    assert not any("gvdb.quiet" in m for m in msgs)
    assert any("span gvdb.failing took" in m for m in msgs)


def test_profile_to_writes_a_chrome_trace(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="grape_vector_db_tpu_torch"):
        with tracing.profile_to(str(tmp_path / "prof")):
            with tracing.trace_span("gvdb.profiled_batch"):
                torch.randn(64, 32) @ torch.randn(32, 64)
    files = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "gvdb.profiled_batch" in names
    assert any(files[0] in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("level,want", [("error", logging.ERROR), ("warn", logging.WARNING),
                                        ("debug", logging.DEBUG), ("trace", logging.DEBUG),
                                        ("bogus", logging.INFO), (None, logging.INFO)])
def test_setup_logging_reads_grape_log(monkeypatch, level, want):
    if level is None:
        monkeypatch.delenv("GRAPE_LOG", raising=False)
    else:
        monkeypatch.setenv("GRAPE_LOG", level)
    saved = (tracing.logger.level, jax_tracing.logger.level)
    try:
        got = tracing.setup_logging()
        assert got is tracing.logger and got.name == "grape_vector_db_tpu_torch"
        assert got.level == want == jax_tracing.setup_logging().level
        assert tracing.setup_logging("error").level == logging.ERROR
    finally:
        tracing.logger.setLevel(saved[0])
        jax_tracing.logger.setLevel(saved[1])


# -- the span recorder ------------------------------------------------------------------

CPU = [torch.profiler.ProfilerActivity.CPU]
INDEX_CHILDREN = ["index.launch", "index.readback", "index.hits"]


def _capture():
    return torch.profiler.profile(activities=CPU)


def _host(records):
    return [s for s in records if s.name != tracing.GC]


def test_spans_nest_with_parent_and_shared_call_ids():
    with _capture():
        with tracing.trace_span("a"):
            with tracing.trace_span("a.b"):
                with tracing.trace_span("a.b.c"):
                    pass
            with tracing.trace_span("a.d"):
                pass
        with tracing.trace_span("e"):
            pass
    by = {s.name: s for s in _host(tracing.spans())}
    assert sorted(by) == ["a", "a.b", "a.b.c", "a.d", "e"]
    assert by["a"].parent_id is None and by["e"].parent_id is None
    assert by["a.b"].parent_id == by["a.d"].parent_id == by["a"].span_id
    assert by["a.b.c"].parent_id == by["a.b"].span_id
    assert {by[n].call_id for n in ("a", "a.b", "a.b.c", "a.d")} == {by["a"].span_id}
    assert by["e"].call_id == by["e"].span_id != by["a"].call_id
    assert len({s.span_id for s in by.values()}) == 5
    assert len({s.thread_id for s in by.values()}) == 1
    for child, parent in (("a.b", "a"), ("a.b.c", "a.b"), ("a.d", "a")):
        assert by[parent].t0_ns <= by[child].t0_ns <= by[child].t1_ns <= by[parent].t1_ns
    assert by["a.b"].t1_ns <= by["a.d"].t0_ns


def test_self_time_leaves_out_a_child_and_a_gc_child():
    with _capture():
        with tracing.trace_span("outer"):
            with tracing.trace_span("outer.child"):
                time.sleep(0.002)
            gc.collect()
            time.sleep(0.001)
    records = tracing.spans()
    outer = next(s for s in records if s.name == "outer")
    child = next(s for s in records if s.name == "outer.child")
    passes = [s for s in records if s.name == tracing.GC and s.parent_id == outer.span_id]
    assert passes and all(s.call_id == outer.span_id for s in passes)
    own = tracing.self_times(records)
    covered = (child.t1_ns - child.t0_ns) + sum(s.t1_ns - s.t0_ns for s in passes)
    assert own[outer.span_id] == outer.t1_ns - outer.t0_ns - covered
    assert own[outer.span_id] >= 1_000_000
    assert own[child.span_id] == child.t1_ns - child.t0_ns


def test_self_time_takes_the_union_of_children_and_skips_device_spans():
    s = tracing.Span
    records = [s("p", 1, None, 1, 7, 0, 100), s("c1", 2, 1, 1, 7, 10, 40),
               s("c2", 3, 1, 1, 7, 30, 50), s(tracing.DEVICE, 4, 1, 1, 7, 0, 100),
               s("late", 5, 1, 1, 7, 90, 130)]
    assert tracing.self_times(records)[1] == 100 - 40 - 10


def test_nothing_is_recorded_without_a_capture():
    with _capture():
        with tracing.trace_span("inside"):
            pass
    before = tracing.spans()
    assert [s.name for s in _host(before)] == ["inside"]
    assert tracing.trace_span("off.a") is tracing.trace_span("off.b")
    with tracing.trace_span("outside"):
        gc.collect()
    assert tracing.spans() == before


def test_a_second_thread_records_inside_the_main_threads_capture():
    seen = []

    def work():
        with tracing.trace_span("worker"):
            with tracing.trace_span("worker.inner"):
                seen.append(torch.autograd._profiler_enabled())

    with _capture():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in _host(tracing.spans())}
    assert sorted(by) == ["worker", "worker.inner"]
    assert by["worker"].thread_id != threading.get_ident()
    assert by["worker.inner"].parent_id == by["worker"].span_id
    assert by["worker"].parent_id is None


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing._RECORDER, "capacity", 5)
    gc.disable()
    try:
        with _capture():
            for i in range(8):
                with tracing.trace_span(f"s{i}"):
                    pass
    finally:
        gc.enable()
    assert [s.name for s in tracing.spans()] == [f"s{i}" for i in range(5)]
    assert tracing.dropped() == 3
    monkeypatch.undo()
    with _capture():
        with tracing.trace_span("next"):
            pass
    assert tracing.dropped() == 0


def test_the_buffer_starts_empty_at_each_new_capture():
    with _capture():
        with tracing.trace_span("first"):
            pass
    with _capture():
        with tracing.trace_span("second"):
            pass
    assert [s.name for s in _host(tracing.spans())] == ["second"]


def test_device_gaps_sum_the_idle_outside_the_device_windows():
    s = tracing.Span
    records = [s("index", 2, 1, 1, 7, 5, 95), s("planner", 1, None, 1, 7, 0, 150),
               s(tracing.DEVICE, 7, 2, 1, 7, 12, 50), s(tracing.DEVICE, 8, 2, 1, 7, 40, 60),
               s("index", 9, 8, 8, 7, 205, 300), s("planner", 8, None, 8, 7, 200, 310),
               s(tracing.DEVICE, 10, 9, 8, 7, 210, 280)]
    # the windows 12-60 (two overlapping) and 210-280: idle 60-210
    assert tracing.device_gaps(records) == 150
    # and 0-12 and 280-400 in a given slice
    assert tracing.device_gaps(records, 0, 400) == 12 + 150 + 120
    # a window not wholly inside the slice is left out
    assert tracing.device_gaps(records, 0, 270) == 270 - 48
    assert tracing.device_gaps([s("x", 1, None, 1, 7, 0, 9)]) == 0


@pytest.mark.parametrize("kind", ["flat", "binary", "int8", "pq"])
def test_a_database_search_records_every_span_once_per_call(kind):
    rows, dim = 16384, 128
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.kind = kind
    db = VectorDatabase(config=cfg, device="cpu")
    x = np.random.default_rng(3).standard_normal((rows, dim)).astype(np.float32)
    db.batch_add_documents([Document(id=str(i), vector=x[i]) for i in range(rows)])
    if kind == "pq":
        db.index.train()     # the ADC prescan and rescore, not the exact scan
        assert db.index.is_trained
    wrapped = {"raw_topk": 0, "hits_from_slots": 0}
    for attr in wrapped:      # as a harness wraps them, through instance attributes
        fn = getattr(db.index, attr)

        def count(*a, _fn=fn, _attr=attr, **kw):
            wrapped[_attr] += 1
            return _fn(*a, **kw)
        setattr(db.index, attr, count)
    batches = [x[:1], x[1:3], x[3:8] + 0.01]
    with _capture():
        answers = [db.vector_search_batch(b, 10) for b in batches]
    assert wrapped == {"raw_topk": 3, "hits_from_slots": 3}
    assert [a[0][0].id for a in answers] == ["0", "1", "3"]
    records = _host(tracing.spans())
    calls = {}
    for s in records:
        calls.setdefault(s.call_id, []).append(s)
    assert len(calls) == 3
    for call in calls.values():
        by = {s.name: s for s in call}
        assert len(by) == len(call) == 6, [s.name for s in call]
        planner, index = by["planner"], by["index"]
        assert planner.parent_id is None and planner.call_id == planner.span_id
        assert index.parent_id == by["planner.points"].parent_id == planner.span_id
        assert all(by[n].parent_id == index.span_id for n in INDEX_CHILDREN)
        order = [by[n] for n in INDEX_CHILDREN] + [by["planner.points"]]
        assert all(a.t1_ns <= b.t0_ns for a, b in zip(order, order[1:]))
        assert planner.t0_ns <= index.t0_ns and index.t1_ns <= by["planner.points"].t0_ns
    assert tracing.DEVICE not in {s.name for s in records}


class _FakeWindow:
    """A device window whose call always takes 1.5 ms."""

    def __init__(self):
        self.ms_total = 0.0
        self.calls = []

    def open(self):
        self.calls.append("open")

    def close(self):
        self.calls.append("close")

    def settle(self):
        self.calls.append("settle")
        self.ms_total += 1.5


def _metric(text, name):
    vals = [float(line.split()[-1]) for line in text.splitlines() if line.split()[0] == name]
    assert len(vals) == 1, name
    return vals[0]


@pytest.mark.parametrize("kind", ["flat", "int8"])
def test_metrics_text_carries_the_always_on_counters(kind):
    cfg = VectorDbConfig(vector_dimension=16)
    cfg.index.kind = kind
    db = VectorDatabase(config=cfg, device="cpu")
    x = np.random.default_rng(5).standard_normal((64, 16)).astype(np.float32)
    db.batch_add_documents([Document(id=str(i), vector=x[i]) for i in range(64)])
    prefix = "grape_vector_db_"
    text = db.metrics.prometheus_text()
    assert _metric(text, prefix + "device_time_ms_total") == 0.0
    assert _metric(text, prefix + "index_lock_wait_seconds_total") == 0.0
    gen2 = prefix + 'gc_pause_seconds_total{generation="2"}'
    g0 = _metric(text, gen2)
    window = db.index._window = _FakeWindow()
    held, release = threading.Event(), threading.Event()

    def hold():
        with db.index.locked():
            held.set()
            release.wait(30)

    t = threading.Thread(target=hold)
    t.start()
    assert held.wait(30)
    threading.Timer(0.1, release.set).start()
    db.vector_search_batch(x[:2], 5)
    t.join(timeout=30)
    assert not t.is_alive()
    db.vector_search_batch(x[2:4], 5)
    gc.collect()
    text = db.metrics.prometheus_text()
    assert window.calls == ["open", "close", "settle"] * 2
    assert _metric(text, prefix + "device_time_ms_total") == 3.0
    assert db.metrics.snapshot().device_time_ms_total == 3.0
    assert 0.05 <= _metric(text, prefix + "index_lock_wait_seconds_total") < 30
    assert _metric(text, gen2) > g0
    assert not hasattr(db.metrics, "record_device_time")


class _FakeEvent:
    """A CUDA event on a fake clock that moves 2 ms at each record."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 2.0
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        assert self.t is not None and end.t is not None and end.t > self.t
        return end.t - self.t


def test_a_device_window_counts_each_pair_once_at_the_next_close_or_a_read(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1, raising=False)
    window = tracing.DeviceWindow(torch.device("cuda", 0))
    pairs, elapsed = [], []

    def call():
        window.open()
        pairs.append(window._turn)
        window.close()
        window.settle()
        elapsed.append(2.0)

    call()
    assert window._ms == 0.0     # counted later, not in the call
    call()
    assert window._ms == 2.0     # the first call's pair, at the second's close
    assert window.ms_total == 4.0 and window._ms == 4.0
    assert window.ms_total == 4.0     # a pair is counted once
    for _ in range(5):
        call()
    assert pairs == [0, 1, 0, 1, 0, 1, 0]
    assert window.ms_total == sum(elapsed) == 14.0
    # a call that fails between its events leaves its pair to the next call
    window.open()
    window.close()
    call()
    assert pairs[-1] == 1 and window.ms_total == 16.0

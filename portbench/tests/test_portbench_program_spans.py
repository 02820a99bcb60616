"""The readers of the program's own spans (``harness/program_spans.py`` and
six ``metrics/*.py``) on a synthetic slice, on a slice without program spans
(a program without the recorder reads nothing), and on a real CPU capture.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from grape_vector_db_tpu_torch import Document, VectorDatabase, VectorDbConfig  # noqa: E402
from grape_vector_db_tpu_torch.utils import tracing  # noqa: E402
from portbench.harness import bench  # noqa: E402

READERS = ["points_ms", "hits_ms", "launch_ms", "readback_wait_ms", "gc_ms", "gap_ms"]
MS = 1_000_000
# two calls' ends, exact in binary: [1.0, 1.015625] and [1.015625, 1.03125] s
CALLS = [(0, 1.0, 1.015625, True), (1, 1.015625, 1.03125, True)]


def read(name, ctx):
    return bench.load_module("metrics", name).read(ctx)


def one_call(base, first_id, with_gc):
    """A call's spans at ``base`` ns, ids from ``first_id``: the planner
    9.8 ms, the index 5.8 ms (launch 1 ms, readback 3.7 ms, hits 0.9 ms), the device window 0.25-4.8 ms, the points 3.8 ms; with
    ``with_gc``, a 0.2-ms pass in the hits and a 1-ms pass in the points."""
    i = first_id
    s = tracing.Span
    out = [s("index.launch", i + 4, i + 1, i, 7, base + 300_000, base + 1_300_000),
           s("index.readback", i + 5, i + 1, i, 7, base + 1_300_000, base + 5_000_000),
           s("index.hits", i + 6, i + 1, i, 7, base + 5_000_000, base + 5_900_000),
           s(tracing.DEVICE, i + 7, i + 1, i, 7, base + 250_000, base + 4_800_000),
           s("index", i + 1, i, i, 7, base + 200_000, base + 6_000_000),
           s("planner.points", i + 8, i, i, 7, base + 6_000_000, base + 9_800_000),
           s("planner", i, None, i, 7, base + 100_000, base + 9_900_000)]
    if with_gc:
        out += [s(tracing.GC, i + 9, i + 6, i, 7, base + 5_500_000, base + 5_700_000),
                s(tracing.GC, i + 10, i + 8, i, 7, base + 7_000_000, base + 8_000_000)]
    return out


def synthetic():
    after = tracing.Span("planner", 99, None, 99, 7, 1_040_000_000, 1_041_000_000)
    return one_call(1_000_000_000, 1, True) + one_call(1_015_625_000, 20, False) + [after]


def ctx_of(calls=CALLS):
    return SimpleNamespace(calls=list(calls))


def test_each_reader_gives_its_mean_per_call(monkeypatch):
    monkeypatch.setattr(tracing, "spans", synthetic)
    got = {name: read(name, ctx_of()) for name in READERS}
    want = {"points_ms": (2.8 + 3.8) / 2, "hits_ms": (0.7 + 0.9) / 2, "launch_ms": 1.0,
            "readback_wait_ms": 3.7, "gc_ms": 1.2 / 2,
            # idle: 0.25 before the first window, 15.625 - 4.8 + 0.25 between
            # them, 15.625 - 4.8 after the second
            "gap_ms": (0.25 + 11.075 + 10.825) / 2}
    assert got == pytest.approx(want, abs=1e-9)


def test_a_failed_call_is_not_counted_and_spans_outside_the_calls_are_not_read(monkeypatch):
    monkeypatch.setattr(tracing, "spans", synthetic)
    one = ctx_of([CALLS[0], (1, 1.015625, 1.03125, False)])
    assert read("launch_ms", one) == 1.0
    assert read("readback_wait_ms", ctx_of(CALLS[:1])) == pytest.approx(3.7)
    assert read("gc_ms", ctx_of(CALLS[1:])) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_no_program_span_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(tracing, "spans", synthetic)
    assert read(name, ctx_of([(0, 2.0, 2.5, True)])) is None
    assert read(name, ctx_of([])) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read(name, ctx_of()) is None
    # a program whose tracing module has no recorder, as the parent's
    monkeypatch.delattr(tracing, "spans")
    assert read(name, ctx_of()) is None


def test_the_device_gap_needs_device_windows(monkeypatch):
    monkeypatch.setattr(tracing, "spans",
                        lambda: [s for s in synthetic() if s.name != tracing.DEVICE])
    assert read("gap_ms", ctx_of()) is None
    assert read("launch_ms", ctx_of()) == 1.0


def test_a_cpu_capture_feeds_every_host_reader():
    import time

    rows, dim = 4096, 32
    db = VectorDatabase(config=VectorDbConfig(vector_dimension=dim), device="cpu")
    x = np.random.default_rng(1).standard_normal((rows, dim)).astype(np.float32)
    db.batch_add_documents([Document(id=str(i), vector=x[i]) for i in range(rows)])
    calls = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for j in range(4):
            t0 = time.perf_counter()
            db.vector_search_batch(x[j:j + 8], 10)
            calls.append((j, t0, time.perf_counter(), True))
    ctx = ctx_of(calls)
    got = {name: read(name, ctx) for name in READERS}
    assert got["gap_ms"] is None     # no device window on the CPU
    for name in READERS[:4]:
        assert got[name] > 0, name
    assert got["gc_ms"] >= 0
    call_ms = sum(c[2] - c[1] for c in calls) / len(calls) * 1e3
    assert got["launch_ms"] + got["readback_wait_ms"] + got["hits_ms"] < call_ms

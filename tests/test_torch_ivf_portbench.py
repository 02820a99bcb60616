"""The IVF deployment of the port's benchmark (``vdbb768d1m-ivf``) on the CPU.

A small corpus of the benchmark's recipe goes through ``VectorDatabase`` with
``kind="ivf"``, the ingest and one ``optimize()``, as the benchmark's load
does, and its answers are held to ``portbench/reference/ivf.py``: within the
cell's limits as they stand, the exact top k once every list is probed, and
flagged where a fault is planted. Also: the IVF search's spans and counters on
``ivf`` and the kinds that reach it through its seams, its query checks, and
``IndexConfig.ivf_train_size`` reaching every IVF kind.
"""

import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from grape_vector_db_tpu_torch import VectorDatabase, VectorDbConfig  # noqa: E402
from grape_vector_db_tpu_torch.db import build_index  # noqa: E402
from grape_vector_db_tpu_torch.utils import tracing  # noqa: E402
from portbench.harness import bench, data, runner  # noqa: E402
from portbench.reference import flat as flat_ref  # noqa: E402
from portbench.reference import ivf as ivf_ref  # noqa: E402

CELL = "ivf1m.batch1000-k10"
K = 10
#: The benchmark's configuration at 8,192 x 128 and nlist 64: 128 rows a
#: list on average, as its 1M rows over 4,096 lists give 244.
CONFIG = {
    "dataset": {"rows": 8192, "dim": 128, "metric": "cosine", "centres": 256, "noise": 0.25},
    "db": {"vector_dimension": 128, "distance": "cosine",
           "index": {"kind": "ivf", "nlist": 64, "nprobe": 8, "initial_capacity": 4096,
                     "ivf_train_size": 1048576},
           "device": {"storage_dtype": "bfloat16", "growth_factor": 2,
                      "search_mode": "exact"}},
    "ingest": {"batch": 2048},
}
SEED = 2**31 + 41


def limits():
    return bench.read_json(os.path.join(ROOT, "portbench", "limits", CELL + ".json"))


@pytest.fixture(scope="module")
def loaded():
    """The database after the benchmark's load, the reference's rows, and
    64 held-out queries."""
    ds = CONFIG["dataset"]
    corpus = data.make_corpus(ds, SEED, "cpu")
    queries = data.make_queries(corpus, ds, {"query_set": 64}, SEED)
    db = VectorDatabase(config=runner.db_config(CONFIG["db"]), device="cpu")
    runner.ingest(db, corpus.x.numpy(), CONFIG["ingest"]["batch"])
    db.optimize()
    assert db.index.get_stats().extra["overflow"] == 0
    rows = ivf_ref.prepare(corpus.x, CONFIG)
    yield db, rows, queries
    db.close()


def search(db, queries, **kw):
    """The database's answers, or with ``kw`` the index's own, as
    ``ScoredPoint``-like objects."""
    if not kw:
        return db.vector_search_batch(queries, K)
    return [[SimpleNamespace(id=i, score=s) for i, s in row]
            for row in db.index.search_batch(queries, K, **kw)]


def test_the_ivf_answers_keep_within_the_cells_limits(loaded):
    db, rows, queries = loaded
    ids, scores, extra = runner.answers(search(db, queries), len(queries), K)
    got = ivf_ref.judge(rows, CONFIG, queries, K, ids, scores)
    assert extra == 0
    assert got["bad_hits"] == 0
    assert got["score_gap"] <= 2e-4
    assert 0.0 <= got["recall_miss"] <= limits()["recall_miss"]["limit"]
    checks, within = runner.judge_limits(got, limits())
    assert within, checks


def test_every_list_probed_gives_the_exact_top_k(loaded):
    db, rows, queries = loaded
    ids, scores, _ = runner.answers(search(db, queries, nprobe=db.index.nlist),
                                    len(queries), K)
    exact = flat_ref.judge(rows, CONFIG, queries, K, ids, scores)
    assert exact["bad_hits"] == 0 and exact["rank_gap"] <= 1e-4
    assert ivf_ref.judge(rows, CONFIG, queries, K, ids, scores)["recall_miss"] == 0.0


def drop_a_row(ids, scores):
    ids[0, 3:], scores[0, 3:] = -1, np.nan          # as ``runner.answers`` marks a miss


def wrong_score(ids, scores):
    scores[5, K - 1] -= 1e-3


def repeat_an_id(ids, scores):
    ids[7, 2] = ids[7, 1]


@pytest.mark.parametrize("fault", [drop_a_row, wrong_score, repeat_an_id])
def test_a_planted_fault_fails_the_cells_limits(loaded, fault):
    db, rows, queries = loaded
    ids, scores, _ = runner.answers(search(db, queries), len(queries), K)
    fault(ids, scores)
    got = ivf_ref.judge(rows, CONFIG, queries, K, ids, scores)
    checks, within = runner.judge_limits(got, limits())
    assert not within, checks
    if fault is drop_a_row:
        assert got["recall_miss"] >= 7 / ids.size and got["bad_hits"] == 7
    elif fault is wrong_score:
        assert got["score_gap"] > limits()["score_gap"]["limit"]
    else:
        assert got["bad_hits"] == 1


def test_the_fp8_control_fails_on_score_gap(loaded):
    _, rows, queries = loaded
    ids, scores = ivf_ref.control(rows, CONFIG, queries, K)
    got = ivf_ref.judge(rows, CONFIG, queries, K, ids, scores.astype(np.float32))
    checks, within = runner.judge_limits(got, limits())
    assert not within
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"], checks


#: A small clustered corpus for the kinds that reach IVF's search through its
#: seams: ``ivf_pq`` (the ADC scan in ``_main_topk``) and ``ivf_int8_proj``
#: (its projection in front of ``search_batch``), whose 128-aligned
#: projection needs more than the benchmark's 128 dimensions.
SEAM_DATA = {"rows": 4096, "dim": 256, "metric": "cosine", "centres": 32, "noise": 0.25}


@pytest.fixture(scope="module", params=["ivf", "ivf_pq", "ivf_int8_proj"])
def trained(request, loaded):
    """A trained database of each kind and its held-out queries: ``ivf`` is
    the benchmark's load; the others ingest ``SEAM_DATA`` and optimize."""
    if request.param == "ivf":
        yield loaded[0], loaded[2]
        return
    corpus = data.make_corpus(SEAM_DATA, SEED, "cpu")
    queries = data.make_queries(corpus, SEAM_DATA, {"query_set": 64}, SEED)
    db = VectorDatabase(config=kind_config(request.param), device="cpu")
    runner.ingest(db, corpus.x.numpy(), 1024)
    db.optimize()
    assert db.index.is_trained and db.index.get_stats().extra["overflow"] == 0
    if request.param == "ivf_pq":
        assert db.index.codebooks is not None    # the ADC scan, not the exact probe
    yield db, queries
    db.close()


def test_the_ivf_search_records_its_spans_under_a_capture(trained):
    db, queries = trained
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for lo in (0, 8, 16):
            db.vector_search_batch(queries[lo:lo + 8], K)
    records = [s for s in tracing.spans() if s.name != tracing.GC]
    calls = {}
    for s in records:
        calls.setdefault(s.call_id, []).append(s)
    assert len(calls) == 3
    for call in calls.values():
        by = {s.name: s for s in call}
        assert len(by) == len(call)
        index = by["index"]
        assert index.parent_id == by["planner"].span_id
        kids = [by[n] for n in ("index.launch", "index.readback", "index.hits")]
        assert all(s.parent_id == index.span_id for s in kids)
        assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))
        assert index.t0_ns <= kids[0].t0_ns and kids[-1].t1_ns <= index.t1_ns
    counters = db.index.counters()
    assert set(counters) == {"index_lock_wait_seconds_total", "device_time_ms_total",
                             "ivf_overflow_merge_rows_total"}
    # optimize() absorbed the load's spill: no row took the overflow merge
    assert counters["ivf_overflow_merge_rows_total"] == 0


def test_an_untrained_ivf_search_records_the_overflows_spans():
    db = VectorDatabase(config=runner.db_config(CONFIG["db"]), device="cpu")
    x = np.random.default_rng(3).standard_normal((100, 128)).astype(np.float32)
    runner.ingest(db, x, 100)
    assert not db.index.is_trained
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = db.vector_search_batch(x[:3], K)
    db.close()
    assert [r[0].id for r in res] == ["0", "1", "2"]
    names = sorted(s.name for s in tracing.spans() if s.name != tracing.GC)
    assert names == ["index", "index.hits", "index.launch", "index.readback", "planner",
                     "planner.points"]


class FakeWindow:
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


def test_metrics_text_carries_the_ivf_counters(trained):
    db, queries = trained
    db.index.lock_wait_s = 0.0
    window = db.index._window = FakeWindow()
    held, release = threading.Event(), threading.Event()

    def hold():
        with db.index.locked():
            held.set()
            release.wait(30)

    t = threading.Thread(target=hold)
    t.start()
    assert held.wait(30)
    threading.Timer(0.1, release.set).start()
    db.vector_search_batch(queries[:2], K)
    t.join(timeout=30)
    db.vector_search_batch(queries[2:4], K)
    text = db.metrics.prometheus_text()
    db.index._window = None
    got = {line.split()[0]: float(line.split()[-1]) for line in text.splitlines()
           if line.startswith("grape_vector_db_") and " " in line}
    assert window.calls == ["open", "close", "settle"] * 2
    assert got["grape_vector_db_device_time_ms_total"] == 3.0
    assert 0.05 <= got["grape_vector_db_index_lock_wait_seconds_total"] < 30


@pytest.mark.parametrize("kind", ["flat", "ivf", "ivf_int8", "ivf_pq"])
def test_a_1d_query_raises_a_value_error(kind):
    index = build_index(kind_config(kind), device="cpu")
    index.add_batch(["a"], np.ones((1, 256), np.float32))
    with pytest.raises(ValueError, match=r"\[B, dim\]"):
        index.search_batch(np.ones(256, np.float32), K)


IVF_KINDS = ["ivf", "ivf_int8", "ivf_int4", "ivf_pq", "ivf_int8_proj", "ivf_int4_proj",
             "sharded_ivf", "sharded_ivf_int8", "sharded_ivf_int4", "sharded_ivf_int8_proj",
             "sharded_ivf_int4_proj"]


def kind_config(kind, **index):
    cfg = VectorDbConfig(vector_dimension=256)
    cfg.index.kind = kind
    cfg.index.nlist = 16
    cfg.index.initial_capacity = 1024
    cfg.index.proj_dim = 128
    for key, val in index.items():
        setattr(cfg.index, key, val)
    return cfg


@pytest.mark.parametrize("kind", IVF_KINDS)
def test_ivf_train_size_reaches_every_ivf_kind(kind):
    assert build_index(kind_config(kind), device="cpu").train_size == 50_000
    index = build_index(kind_config(kind, ivf_train_size=1_048_576), device="cpu")
    assert index.train_size == 1_048_576


def test_the_training_sample_is_the_configured_size(monkeypatch):
    from grape_vector_db_tpu_torch.index import ivf as ivf_mod

    seen = []
    orig = ivf_mod.kmeans

    def spy(x, **kw):
        seen.append(x.shape[0])
        return orig(x, **kw)

    monkeypatch.setattr(ivf_mod, "kmeans", spy)
    x = np.random.default_rng(4).standard_normal((4096, 256)).astype(np.float32)
    for size, want in ((1000, 1000), (1_048_576, 4096)):
        index = build_index(kind_config("ivf", ivf_train_size=size), device="cpu")
        index.train(x)
        assert seen[-1] == want

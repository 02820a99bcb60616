"""The port's main path end to end against the JAX package, on the CPU.

The same documents (numpy vectors from a seed, short content, an integer
metadata field) and queries go through the JAX ``VectorDatabase`` and the
port's (``device="cpu"``): batch search at k=10, single search at k=3,
filtered search, then again after deletes. Default configuration: flat,
cosine, bf16 storage. Tolerance 1e-4 (bf16 storage on the CPU), ids as sets
with the near-tie guard (tests/torch_parity.py).

The run is made twice: at the default routing thresholds (the corpus is
small, so the port scores with one matmul), and with the port's thresholds
lowered so that its segment-kernel route (plain versions on the CPU) serves
N=8192 — the JAX side keeps its defaults and stays the exact reference.
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu import VectorDatabase as JaxDatabase
from grape_vector_db_tpu import VectorDbConfig as JaxConfig
from grape_vector_db_tpu.types import Condition as JaxCondition
from grape_vector_db_tpu.types import Document as JaxDocument
from grape_vector_db_tpu.types import Filter as JaxFilter
from grape_vector_db_tpu.types import HybridSearchRequest as JaxHybrid
from grape_vector_db_tpu.types import SearchRequest as JaxSearchRequest
from grape_vector_db_tpu_torch import (Condition, Document, Filter, HybridSearchRequest,
                                       SearchRequest, VectorDatabase, VectorDbConfig)
from grape_vector_db_tpu_torch.db import build_index
from grape_vector_db_tpu_torch.errors import StateError
from grape_vector_db_tpu_torch.ops import distance as tdist
from grape_vector_db_tpu_torch.ops import segmax as tseg
from torch_parity import assert_hits_match

torch.set_num_threads(2)

N, D, B = 6000, 128, 16
TOL = 1e-4


def _docs(cls, x, start):
    return [cls(id=f"d{i}", content=f"document {i} about topic {i % 7}",
                vector=x[i], metadata={"bucket": i % 10})
            for i in range(start, min(start + 2048, len(x)))]


def _rows(points):
    return [(p.id, p.score) for p in points]


@pytest.mark.parametrize("route", ["default", "segmax"])
def test_main_path_matches_jax(rng, monkeypatch, route):
    x = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    jdb = JaxDatabase(config=JaxConfig(vector_dimension=D))
    tdb = VectorDatabase(config=VectorDbConfig(vector_dimension=D), device="cpu")
    for i in range(0, N, 2048):
        jdb.batch_add_documents(_docs(JaxDocument, x, i))
        tdb.batch_add_documents(_docs(Document, x, i))
    assert tdb.index.capacity == jdb.index.capacity == 8192
    calls = []
    if route == "segmax":
        monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 4096)
        for name in ("segmax4_scores", "segmax2_scores"):
            fn = getattr(tseg, name)
            monkeypatch.setattr(tseg, name,
                                lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))

    def check_all(deleted=frozenset()):
        got = tdb.vector_search_batch(queries, 10)
        want = jdb.vector_search_batch(queries, 10)
        assert_hits_match([_rows(r) for r in got], [_rows(r) for r in want], TOL)
        for q in queries[:4]:
            got = tdb.vector_search(SearchRequest(vector=q.tolist(), limit=3))
            want = jdb.vector_search(JaxSearchRequest(vector=q.tolist(), limit=3))
            assert_hits_match([_rows(got)], [_rows(want)], TOL)
            got = tdb.vector_search(SearchRequest(
                vector=q.tolist(), limit=10,
                filter=Filter(must=[Condition("bucket", "eq", 3)])))
            want = jdb.vector_search(JaxSearchRequest(
                vector=q.tolist(), limit=10,
                filter=JaxFilter(must=[JaxCondition("bucket", "eq", 3)])))
            assert_hits_match([_rows(got)], [_rows(want)], TOL)
            assert len(got) == 10
            assert all(int(p.id[1:]) % 10 == 3 for p in got)
            assert not {p.id for p in got} & deleted

    check_all()
    # delete the current top hits, so the next answers must change
    doomed = {p.id for row in tdb.vector_search_batch(queries, 10) for p in row}
    assert tdb.batch_delete_documents(sorted(doomed)) == len(doomed)
    assert jdb.batch_delete_documents(sorted(doomed)) == len(doomed)
    check_all(frozenset(doomed))
    got = tdb.vector_search_batch(queries, 10)
    assert not {p.id for row in got for p in row} & doomed
    assert tdb.stats().document_count == N - len(doomed)
    assert tdb.health_check()["index_consistent"]
    if route == "segmax":
        # batch and filtered searches (k=10) took the top-4 engine, the k=3
        # searches the top-2 engine
        assert set(calls) == {"segmax4_scores", "segmax2_scores"}
    else:
        assert not calls
    jdb.close()
    tdb.close()


def test_text_and_hybrid_search_match_jax(rng):
    """The copied host engines over the port's index: dense+text search,
    text search and hybrid (RRF) search return what the JAX database does."""
    x = rng.standard_normal((600, D)).astype(np.float32)
    jdb = JaxDatabase(config=JaxConfig(vector_dimension=D))
    tdb = VectorDatabase(config=VectorDbConfig(vector_dimension=D), device="cpu")
    jdb.batch_add_documents(_docs(JaxDocument, x, 0)[:600])
    tdb.batch_add_documents(_docs(Document, x, 0)[:600])
    q = (x[7] + 0.3 * rng.standard_normal(D)).astype(np.float32).tolist()

    def rows(results):
        return [[(r.document.id, r.score) for r in results]]

    assert_hits_match(rows(tdb.search(SearchRequest(query="topic 3", vector=q, limit=10))),
                      rows(jdb.search(JaxSearchRequest(query="topic 3", vector=q, limit=10))),
                      TOL)
    assert_hits_match(rows(tdb.text_search(SearchRequest(query="document 42", limit=5))),
                      rows(jdb.text_search(JaxSearchRequest(query="document 42", limit=5))),
                      TOL)
    got = tdb.hybrid_search(HybridSearchRequest(query="topic 3", dense_vector=q, limit=10))
    want = jdb.hybrid_search(JaxHybrid(query="topic 3", dense_vector=q, limit=10))
    assert_hits_match(rows(got), rows(want), TOL)
    assert len(got) == 10
    jdb.close()
    tdb.close()
    with pytest.raises(StateError):
        tdb.add_document(Document(id="late", content="x", vector=q))


@pytest.mark.parametrize("kind", ["sharded_flat", "sharded_ivf", "sharded_ivf_int8",
                                  "sharded_ivf_int4", "auto_shard"])
def test_sharded_kinds_answer_as_the_unsharded_kind(rng, monkeypatch, kind):
    """Every sharded kind builds (``auto_shard`` on a host of four CPU
    devices builds ``sharded_flat``) and answers as its unsharded kind on
    the same documents: ids with the near-tie guard, scores within 1e-4
    (bf16 storage; the IVF kinds probe every list)."""
    from grape_vector_db_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "local_devices", lambda device="cuda": [torch.device("cpu")] * 4)
    cfg = VectorDbConfig(vector_dimension=D)
    cfg.index.nlist = cfg.index.nprobe = 8
    if kind == "auto_shard":
        cfg.device.auto_shard = True
        base = "flat"
    else:
        cfg.index.kind = kind
        base = kind.removeprefix("sharded_")
    idx = build_index(cfg, device="cpu")
    assert idx.kind == ("sharded_flat" if kind == "auto_shard" else kind) and idx.n_shards == 4
    cfg.index.kind, cfg.device.auto_shard = base, False
    plain = build_index(cfg, device="cpu")
    x = rng.standard_normal((1200, D)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(x))]
    for index in (idx, plain):
        index.add_batch(ids, x)
        if hasattr(index, "centroids"):
            index.optimize()
    q = np.concatenate([x[:4] + 0.05, rng.standard_normal((4, D)).astype(np.float32)])
    assert_hits_match(idx.search_batch(q, 10), plain.search_batch(q, 10), 1e-4)


@pytest.mark.parametrize("kind", ["flat", "ivf", "ivf_int8", "ivf_int4"])
def test_auto_shard_on_one_device_builds_the_unsharded_kind(rng, kind):
    """As in the reference (db.py build_index), ``auto_shard`` upgrades to a
    sharded kind only where there is more than one local device; on the CPU
    (and on one GPU) the port builds the kind as asked. The JAX side is built
    without ``auto_shard``: its tests run on 8 virtual CPU devices, where it
    would shard. IVF kinds probe every list (nprobe = nlist), so the
    partition, whose k-means start differs across engines, does not decide
    the answer. Tolerance 1e-4 for flat, 3e-3 for the IVF kinds (as
    tests/test_torch_ivf.py)."""
    from grape_vector_db_tpu_torch.index import (FlatDeviceIndex, Int4IvfDeviceIndex,
                                                 Int8IvfDeviceIndex, IvfDeviceIndex)

    cls = {"flat": FlatDeviceIndex, "ivf": IvfDeviceIndex, "ivf_int8": Int8IvfDeviceIndex,
           "ivf_int4": Int4IvfDeviceIndex}[kind]
    x = rng.standard_normal((1200, D)).astype(np.float32)
    queries = np.concatenate([x[:4] + 0.05 * rng.standard_normal((4, D)).astype(np.float32),
                              rng.standard_normal((4, D)).astype(np.float32)])
    dbs = []
    for cfg_cls, db_cls, doc_cls, kw, shard in (
            (JaxConfig, JaxDatabase, JaxDocument, {}, False),
            (VectorDbConfig, VectorDatabase, Document, {"device": "cpu"}, True)):
        cfg = cfg_cls(vector_dimension=D)
        cfg.index.kind = kind
        cfg.index.nlist = cfg.index.nprobe = 8
        cfg.device.auto_shard = shard
        db = db_cls(config=cfg, **kw)
        db.batch_add_documents(_docs(doc_cls, x, 0)[:1000])
        db.batch_add_documents(_docs(doc_cls, x, 1000))
        dbs.append(db)
    jdb, tdb = dbs
    assert type(tdb.index) is cls and tdb.index.kind == kind
    assert type(jdb.index).__name__ == cls.__name__
    tol = TOL if kind == "flat" else 3e-3
    got = tdb.vector_search_batch(queries, 10)
    want = jdb.vector_search_batch(queries, 10)
    assert_hits_match([_rows(r) for r in got], [_rows(r) for r in want], tol)
    assert all(len(r) == 10 for r in got)
    jdb.close()
    tdb.close()

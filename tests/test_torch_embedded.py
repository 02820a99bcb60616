"""The embedded deployment and the db's host surface, port against the JAX
package on the CPU.

- The db surface: the same calls through both packages (listing, counting,
  filtered listing, ``search_documents``, pipelined ingest, the enterprise
  wrappers, backups, reopen from ``path``) give the same ids, counts and
  results; scores within 1e-4 (f32 storage, products summed in another
  order), ids as sets with the near-tie guard.
- Index snapshots cross the packages both ways.
- tests/test_db.py's lifecycle, async, batched single-query and shutdown
  cases through the port's ``EmbeddedVectorDB``.
- The port's top-level exports are the reference's ``__all__``.
"""

import asyncio
import concurrent.futures

import numpy as np
import pytest
import torch

import grape_vector_db_tpu as jax_pkg
import grape_vector_db_tpu_torch as torch_pkg
from grape_vector_db_tpu.services import enterprise as jent
from grape_vector_db_tpu_torch.errors import AuthorizationError, InvalidArgumentError, StateError
from grape_vector_db_tpu_torch.services import enterprise as tent
from torch_parity import assert_hits_match

torch.set_num_threads(2)

TOL = 1e-4
PKGS = {"jax": (jax_pkg, {}, jent), "torch": (torch_pkg, {"device": "cpu"}, tent)}


def small_config(top, dim=32):
    cfg = top.VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.initial_capacity = 256
    return cfg


def make_docs(top, n, prefix="doc", vectors=None):
    return [top.Document(
        id=f"{prefix}-{i}", title=f"Title {i}",
        content=f"the content body of document number {i} talks about topic{i % 5}",
        metadata={"category": "even" if i % 2 == 0 else "odd", "rank": i},
        vector=None if vectors is None else vectors[i])
        for i in range(n)]


def _rows(points):
    return [(p.id, p.score) for p in points]


def _result_rows(results):
    return [(r.document.id, r.score) for r in results]


def _db(name, path=None, **cfg_over):
    top, kw, _ = PKGS[name]
    return top.VectorDatabase(path=path, config=small_config(top, **cfg_over), **kw)


def test_db_surface_matches_jax(rng, tmp_path):
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    out = {}
    for name, (top, _, ent) in PKGS.items():
        db = _db(name, path=str(tmp_path / name))
        r = out[name] = {}
        with db.write_lock:   # reentrant: a write inside it does not deadlock
            db.batch_add_documents(make_docs(top, 1, prefix="lock", vectors=vecs))
            db.delete_document("lock-0")
        r["ids"] = db.add_documents_pipelined(make_docs(top, 300, vectors=vecs),
                                              batch_size=64, inflight=3)
        f = top.Filter(must=[top.Condition("category", "eq", "even")])
        r["count"] = (db.count_documents(), db.count_documents(f))
        r["list"] = [d.id for d in db.list_documents(offset=10, limit=20, filter=f)]
        r["page"] = sorted(d.id for d in db.list_documents(offset=0, limit=1000))
        r["search_documents"] = _result_rows(db.search_documents(
            "Title 13 the content body of document number 13 talks about topic3", limit=5))
        r["fallback"] = _result_rows(db.search_documents("number 7 talks", limit=3))
        r["batch"] = [_rows(row) for row in db.vector_search_batch(queries, 10)]
        auth = db.enable_enterprise()
        writer = auth.create_api_key("writer", ent.Role.DATA_MANAGER)
        reader = auth.create_api_key("reader", ent.Role.READ_ONLY_USER)
        db.add_documents_with_auth(writer.key, make_docs(top, 5, prefix="w", vectors=vecs))
        with pytest.raises(Exception) as denied:
            db.add_documents_with_auth(reader.key, make_docs(top, 1, prefix="x", vectors=vecs))
        r["denied"] = type(denied.value).__name__
        r["auth_search"] = _result_rows(db.search_with_auth(
            reader.key, top.SearchRequest(vector=vecs[1].tolist(), limit=3)))
        r["auth_delete"] = db.delete_documents_with_auth(writer.key, ["doc-0", "w-1", "nope"])
        db.create_backup(str(tmp_path / f"{name}.bak"))
        db.batch_delete_documents([f"doc-{i}" for i in range(100)])
        r["after_delete"] = db.count_documents()
        r["restore"] = db.restore_backup(str(tmp_path / f"{name}.bak"))["restored"]
        r["restored"] = (db.count_documents(), len(db.index))
        db.flush()
        db.close()
        db2 = _db(name, path=str(tmp_path / name))
        r["reopened"] = (db2.count_documents(), len(db2.index),
                         [_rows(row) for row in db2.vector_search_batch(queries, 10)])
        # the rebuilt BM25 index scores as the reference's (many documents
        # tie on these terms: which tied ids fill the cut is arbitrary, and
        # the near-tie guard allows for it)
        r["text"] = [db2.sparse.search_bm25(q, 10)
                     for q in ("document number 17", "topic3 talks", "Title 250")]
        db2.close()
    j, t = out["jax"], out["torch"]
    for key in ("ids", "count", "list", "page", "denied", "auth_delete", "after_delete",
                "restore", "restored"):
        assert t[key] == j[key], key
    assert t["denied"] == "AuthorizationError"
    assert t["count"] == (300, 150) and t["restored"] == (303, 303)
    assert_hits_match([t["search_documents"], t["fallback"], t["auth_search"]],
                      [j["search_documents"], j["fallback"], j["auth_search"]], TOL)
    assert len(t["search_documents"]) == 5 and len(t["fallback"]) == 3
    assert_hits_match(t["batch"], j["batch"], TOL)
    assert t["reopened"][:2] == j["reopened"][:2] == (303, 303)
    assert_hits_match(t["reopened"][2], j["reopened"][2], TOL)
    assert_hits_match(t["text"], j["text"], TOL)
    assert all(t["text"])


def test_guarded_api_needs_enterprise():
    db = _db("torch")
    with pytest.raises(StateError):
        db.search_with_auth("gvdb_nope", torch_pkg.SearchRequest(query="x"))
    assert db.auth is None and db.resilience is None
    auth = db.enable_enterprise()
    reader = auth.create_api_key("reader", tent.Role.READ_ONLY_USER)
    with pytest.raises(AuthorizationError):
        db.delete_documents_with_auth(reader.key, ["a"])
    db.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_index_snapshot_crosses(rng, tmp_path, writer, reader):
    vecs = rng.standard_normal((120, 32)).astype(np.float32)
    queries = rng.standard_normal((5, 32)).astype(np.float32)
    src = _db(writer)
    src.batch_add_documents(make_docs(PKGS[writer][0], 120, vectors=vecs))
    snap = str(tmp_path / "index.snap")
    assert src.save_index(snap)["points"] == 120
    dst = _db(reader)
    assert dst.load_index(snap)["points"] == 120
    want = [_rows(row) for row in src.vector_search_batch(queries, 10)]
    got = [_rows(row) for row in dst.vector_search_batch(queries, 10)]
    assert_hits_match(got, want, TOL)
    bad = _db(reader, dim=16)
    with pytest.raises(Exception, match="dimension"):
        bad.load_index(snap)


def test_index_snapshot_zlib_route(rng, tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "zstandard", None)
    vecs = rng.standard_normal((50, 32)).astype(np.float32)
    db = _db("torch")
    db.batch_add_documents(make_docs(torch_pkg, 50, vectors=vecs))
    snap = str(tmp_path / "index.snap")
    db.save_index(snap)
    with open(snap, "rb") as f:
        assert f.read(8) == b"GVDBZLB1"
    db2 = _db("torch")
    db2.load_index(snap)
    hits = db2.vector_search(torch_pkg.SearchRequest(vector=vecs[9].tolist(), limit=1))
    assert hits[0].id == "doc-9"
    with pytest.raises(InvalidArgumentError):
        _db("torch", dim=16).load_index(snap)


def test_vector_database_path_reopens(rng, tmp_path):
    path = str(tmp_path / "db")
    vecs = rng.standard_normal((25, 32)).astype(np.float32)
    db = torch_pkg.VectorDatabase(path=path, config=small_config(torch_pkg), device="cpu")
    assert isinstance(db.store, torch_pkg.storage.FileDocumentStore)
    db.batch_add_documents(make_docs(torch_pkg, 25, vectors=vecs))
    db.close()
    with pytest.raises(StateError):
        db.batch_add_documents(make_docs(torch_pkg, 1, vectors=vecs))
    db2 = torch_pkg.VectorDatabase(path=path, config=small_config(torch_pkg), device="cpu")
    assert db2.stats().document_count == 25 and len(db2.index) == 25
    assert db2.vector_search(torch_pkg.SearchRequest(vector=vecs[3].tolist(),
                                                     limit=3))[0].id == "doc-3"
    db2.close()


def test_pipelined_propagates_errors(rng):
    db = _db("torch")
    docs = make_docs(torch_pkg, 120, prefix="er",
                     vectors=rng.standard_normal((120, 32)).astype(np.float32))
    docs[70].vector = rng.standard_normal(16).astype(np.float32)
    with pytest.raises(InvalidArgumentError):
        db.add_documents_pipelined(docs, batch_size=32, inflight=2)
    with pytest.raises(InvalidArgumentError):
        db.add_documents_pipelined(docs, batch_size=0)


def _embedded(tmp_path, name):
    cfg = torch_pkg.EmbeddedConfig(data_dir=str(tmp_path / name),
                                   db=small_config(torch_pkg))
    cfg.health_check_interval_s = 0
    return torch_pkg.EmbeddedVectorDB(cfg, device="cpu")


def test_embedded_lifecycle(tmp_path):
    with _embedded(tmp_path, "edb") as edb:
        assert edb.state == torch_pkg.DbState.READY
        assert edb.db.index.device.type == "cpu"
        ids = edb.upsert(make_docs(torch_pkg, 10))
        assert len(ids) == 10
        doc = edb.get("doc-2")
        hits = edb.vector_search(torch_pkg.SearchRequest(vector=doc.vector, limit=3))
        assert hits[0].id == "doc-2"
        assert edb.health_check().status == torch_pkg.CheckStatus.HEALTHY
        assert edb.stats().document_count == 10
    assert edb.state == torch_pkg.DbState.CLOSED
    with pytest.raises(StateError):
        edb.get("doc-2")


def test_embedded_async(tmp_path):
    async def main():
        edb = _embedded(tmp_path, "adb")
        await edb.upsert_async(make_docs(torch_pkg, 8))
        doc = edb.get("doc-1")
        hits = await edb.vector_search_async(torch_pkg.SearchRequest(vector=doc.vector,
                                                                     limit=2))
        assert hits[0].id == "doc-1"
        res = await edb.search_async(torch_pkg.SearchRequest(query="document number 5",
                                                             limit=2))
        assert res
        assert await edb.delete_async(["doc-1"]) == 1
        edb.close()

    asyncio.run(main())


def test_embedded_batched_single_queries(tmp_path):
    with _embedded(tmp_path, "bdb") as edb:
        edb.upsert(make_docs(torch_pkg, 30))
        vecs = [edb.get(f"doc-{i}").vector for i in range(8)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            rows = list(ex.map(lambda v: edb.vector_search_one(v, 3), vecs))
        for i, row in enumerate(rows):
            assert row[0].id == f"doc-{i}"
        assert edb.executor.queries_run == 8


def test_embedded_shutdown_hooks_and_reopen(tmp_path):
    edb = _embedded(tmp_path, "hdb")
    ran = []
    edb.lifecycle.add_shutdown_hook(lambda: ran.append("hook"))
    edb.upsert(make_docs(torch_pkg, 5))
    edb.close()
    edb.close()  # idempotent
    assert ran == ["hook"]
    with _embedded(tmp_path, "hdb") as again:
        assert len(again.db.index) == 5
        assert again.health_check().status == torch_pkg.CheckStatus.HEALTHY


def test_top_level_exports_match_reference():
    assert torch_pkg.__all__ == jax_pkg.__all__
    for name in jax_pkg.__all__:
        assert hasattr(torch_pkg, name), name
    for name in ("EmbeddedVectorDB", "EmbeddedConfig", "DbState", "CheckResult",
                 "CheckStatus"):
        assert getattr(torch_pkg, name).__module__.startswith("grape_vector_db_tpu_torch.")


def test_pipelined_ingest_stress(rng):
    """More in-flight batches than cores, with a short switch interval: every
    document lands once in the store, the index and BM25, and each id keeps
    its own row."""
    import sys
    import time

    vecs = rng.standard_normal((600, 32)).astype(np.float32)
    db = _db("torch")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.monotonic()
        ids = db.add_documents_pipelined(make_docs(torch_pkg, 600, vectors=vecs),
                                         batch_size=16, inflight=24)
        assert time.monotonic() - t0 < 120
    finally:
        sys.setswitchinterval(old)
    assert ids == [f"doc-{i}" for i in range(600)]
    assert db.count_documents() == len(db.index) == 600
    for i in (0, 299, 599):
        np.testing.assert_array_equal(db.index.get_vector(f"doc-{i}"), vecs[i])
        assert db.text_search(torch_pkg.SearchRequest(query=f"number {i} talks", limit=1))
    db.close()

"""The single-node server deployment, port against the JAX package on the CPU.

- One corpus (a few hundred rows, D = 16, f32 storage) goes into a JAX
  database and a port database (``device="cpu"``); each is served by its own
  package's gRPC and REST servers on port 0, and the same requests go to
  both. Every RPC and REST route that tests/test_server.py exercises, and
  every REST route with its 404, answers alike: ids as sets with the
  near-tie guard, scores within 3e-3 (the repo's rule: tests/torch_parity.py),
  payloads, snippets, counts and status codes equal.
- Both packages speak one wire format: the port's message classes are the
  JAX package's, and each package's client talks to the other's server.
- tests/test_server.py's own cases through the port: the micro-batcher,
  API keys, TLS and mTLS, ``ef`` and ``host_rescore`` reaching the engine,
  and ``cli serve`` as a subprocess with ``--device cpu``.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import grpc
import numpy as np
import pytest
import torch

import grape_vector_db_tpu as jax_pkg
import grape_vector_db_tpu_torch as torch_pkg
from grape_vector_db_tpu.server import grpc_server as jax_grpc
from grape_vector_db_tpu.server import rest as jax_rest
from grape_vector_db_tpu.server.proto import vector_db_pb2 as jax_pb
from grape_vector_db_tpu_torch.server import grpc_server as tgrpc
from grape_vector_db_tpu_torch.server import rest as trest
from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
from examples_parity import PORT_ONLY_METRICS
from torch_parity import assert_hits_match

torch.set_num_threads(2)

TOL = 3e-3
DIM = 16
ROWS = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jax_pkg, jax_grpc, jax_rest, {}),
        "torch": (torch_pkg, tgrpc, trest, {"device": "cpu"})}


def small_db(name, dim=DIM, cache=True, **index):
    top, _, _, kw = PKGS[name]
    cfg = top.VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.cache.enabled = cache
    cfg.index.initial_capacity = 512
    for key, value in index.items():
        setattr(cfg.index, key, value)
    return top.VectorDatabase(config=cfg, **kw)


class Served:
    """One package's database behind its own gRPC and REST servers."""

    def __init__(self, name, db=None, tls=None):
        _, grpc_mod, rest_mod, _ = PKGS[name]
        self.db = db if db is not None else small_db(name)
        self.server, port, self.servicer = grpc_mod.build_grpc_server(self.db, port=0,
                                                                      tls=tls)
        self.server.start()
        self.address = f"127.0.0.1:{port}"
        self.client = grpc_mod.VectorDbClient(self.address)
        self.rest = rest_mod.RestServer(self.db, port=0)
        host, rport = self.rest.start()
        self.base = f"http://{host}:{rport}"

    def call(self, method, request):
        return self.client.call(method, request)

    def stop(self):
        self.client.close()
        self.rest.stop()
        self.server.stop(grace=0)
        self.db.close()


@pytest.fixture()
def both():
    served = {name: Served(name) for name in PKGS}
    yield served
    for s in served.values():
        s.stop()


def corpus(n=ROWS, dim=DIM, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def points(vecs, prefix="v"):
    return [pb.Point(id=f"{prefix}{i}", vector=pb.Vector(values=v.astype(float)),
                     payload={"group": "a" if i % 2 == 0 else "b", "n": str(i)})
            for i, v in enumerate(vecs)]


def _req(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return resp.status, json.loads(raw or b"{}") if "json" in ctype else raw.decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def assert_same_results(got, want):
    """Two lists of results (proto messages or REST dicts): ids by the
    repo's rule, scores within TOL; each common id's payload and snippet
    equal."""
    def rows(rs):
        return [((r["id"], r["score"]) if isinstance(r, dict) else (r.id, r.score))
                for r in rs]

    assert_hits_match([rows(got)], [rows(want)], TOL)

    def extras(rs):
        out = {}
        for r in rs:
            if isinstance(r, dict):
                out[r["id"]] = (r.get("payload"), r.get("snippet"))
            else:
                out[r.id] = (dict(r.payload), r.snippet)
        return out

    g, w = extras(got), extras(want)
    for i in set(g) & set(w):
        assert g[i] == w[i], (i, g[i], w[i])


def same_message(a, b, skip=()):
    """Two proto messages field by field, apart from ``skip``."""
    for f in a.DESCRIPTOR.fields:
        if f.name not in skip:
            assert getattr(a, f.name) == getattr(b, f.name), f.name


# -- one wire format --------------------------------------------------------------


def test_one_wire_format(both):
    """The port's message classes are the JAX package's (one descriptor, one
    proto package), so each package's client talks to the other's server."""
    assert pb.SearchVectorsRequest is jax_pb.SearchVectorsRequest
    assert tgrpc.SERVICE_NAME == jax_grpc.SERVICE_NAME
    vecs = corpus(40)
    port_client = tgrpc.VectorDbClient(both["jax"].address)
    jax_client = jax_grpc.VectorDbClient(both["torch"].address)
    try:
        assert port_client.upsert_points(points(vecs)).upserted == 40
        assert jax_client.upsert_points(points(vecs)).upserted == 40
        for i in (3, 17):
            a = port_client.search(vecs[i].astype(float).tolist(), limit=5)
            b = jax_client.search(vecs[i].astype(float).tolist(), limit=5)
            assert a.results[0].id == b.results[0].id == f"v{i}"
            assert_same_results(a.results, b.results)
        same_message(port_client.call("GetStats", pb.GetStatsRequest()),
                     jax_client.call("GetStats", pb.GetStatsRequest()),
                     skip=("uptime_s", "storage_bytes", "index_kind"))
    finally:
        port_client.close()
        jax_client.close()


# -- gRPC: the same requests to both servers ------------------------------------------


def test_grpc_vector_rpcs_match_jax(both):
    vecs = corpus()
    for s in both.values():
        resp = s.client.upsert_points(points(vecs))
        assert resp.upserted == ROWS and not resp.error
    j, t = both["jax"], both["torch"]
    for id_ in ("v3", "v200", "missing"):
        a = t.call("GetVector", pb.GetVectorRequest(id=id_))
        b = j.call("GetVector", pb.GetVectorRequest(id=id_))
        assert a.found == b.found == (id_ != "missing")
        assert a.point.id == b.point.id and dict(a.point.payload) == dict(b.point.payload)
        np.testing.assert_allclose(a.point.vector.values, b.point.vector.values, atol=1e-6)
    queries = np.concatenate([vecs[:6] + 0.1 * corpus(6, seed=1), corpus(6, seed=2)])
    for q in queries.astype(float).tolist():
        for kw in ({"with_payload": False},                   # the micro-batcher
                   {"limit": 3, "with_payload": False},
                   {"with_payload": True},
                   {"filter_sql": "group = 'a'"},
                   {"limit": 8, "filter_sql": "n < 40 AND group = 'b'"}):
            a, b = t.client.search(q, **kw), j.client.search(q, **kw)
            assert not a.error and not b.error and len(a.results) == len(b.results) > 0
            assert_same_results(a.results, b.results)
        a = t.call("SearchVectors", pb.SearchVectorsRequest(
            query=pb.Vector(values=q), limit=10, score_threshold=0.3))
        b = j.call("SearchVectors", pb.SearchVectorsRequest(
            query=pb.Vector(values=q), limit=10, score_threshold=0.3))
        assert_same_results(a.results, b.results)
        assert all(r.score >= 0.3 for r in a.results)
    doomed = [f"v{i}" for i in range(0, ROWS, 7)] + ["missing"]
    a = t.call("DeleteVector", pb.DeleteVectorRequest(ids=doomed))
    b = j.call("DeleteVector", pb.DeleteVectorRequest(ids=doomed))
    assert a.deleted == b.deleted == len(doomed) - 1
    for q in vecs[:14:7].astype(float).tolist():
        a, b = t.client.search(q, limit=10), j.client.search(q, limit=10)
        assert not {r.id for r in a.results} & set(doomed)
        assert_same_results(a.results, b.results)
    same_message(t.call("GetStats", pb.GetStatsRequest()),
                 j.call("GetStats", pb.GetStatsRequest()),
                 skip=("uptime_s", "storage_bytes", "index_kind"))


def test_grpc_document_rpcs_match_jax(both):
    docs = [pb.Document(id=f"d{i}", title=f"T{i}",
                        content=f"all about {'tpus' if i % 2 == 0 else 'pasta'} {i}",
                        metadata={"i": str(i)}) for i in range(12)]
    docs.append(pb.Document(id="dv", content="a document with its own vector",
                            vector=corpus(1)[0].astype(float)))
    j, t = both["jax"], both["torch"]
    a = t.call("AddDocument", pb.AddDocumentRequest(documents=docs))
    b = j.call("AddDocument", pb.AddDocumentRequest(documents=docs))
    assert list(a.ids) == list(b.ids) == [d.id for d in docs] and not a.error
    for id_ in ("d4", "dv", "nope"):
        a = t.call("GetDocument", pb.GetDocumentRequest(id=id_))
        b = j.call("GetDocument", pb.GetDocumentRequest(id=id_))
        assert a.found == b.found == (id_ != "nope")
        same_message(a.document, b.document, skip=("vector",))
        np.testing.assert_allclose(a.document.vector, b.document.vector, atol=1e-6)
    for mode in ("semantic", "text", "hybrid"):
        for fsql in ("", "i < 6"):
            req = pb.SearchDocumentsRequest(query="tpus", limit=5, mode=mode, filter_sql=fsql)
            a, b = t.call("SearchDocuments", req), j.call("SearchDocuments", req)
            assert not a.error and not b.error, (a.error, b.error)
            assert_same_results(a.results, b.results)
            if mode == "text":
                assert a.results and all(int(r.id[1:]) % 2 == 0 for r in a.results)
            assert a.results
    req = pb.SearchDocumentsRequest(query="tpus", limit=5, mode="hybrid", fusion="nope")
    assert t.call("SearchDocuments", req).error == j.call("SearchDocuments", req).error != ""
    a = t.call("DeleteDocument", pb.DeleteDocumentRequest(ids=["d1", "d2", "nope"]))
    b = j.call("DeleteDocument", pb.DeleteDocumentRequest(ids=["d1", "d2", "nope"]))
    assert a.deleted == b.deleted == 2
    a, b = t.call("GetStats", pb.GetStatsRequest()), j.call("GetStats", pb.GetStatsRequest())
    same_message(a, b, skip=("uptime_s", "storage_bytes"))
    assert a.document_count == 11 and a.index_size == 11
    names = []
    for s in (t, j):
        text = s.call("GetMetrics", pb.GetMetricsRequest()).prometheus_text
        names.append({line.split()[0] for line in text.splitlines()
                      if line and not line.startswith("#")})
    assert "grape_vector_db_queries_total" in names[0]
    # the device memory gauges: the port samples only a process that uses
    # CUDA, the JAX package its CPU devices; the port alone exports its
    # index's lock wait and the collector's pauses
    assert ({n for n in names[0] if "hbm" not in n}
            == {n for n in names[1] if "hbm" not in n} | PORT_ONLY_METRICS)


def test_grpc_cluster_and_shard_groups_match_jax(both):
    """Standalone answers of the cluster, Raft and shard groups and the
    Internal carrier, field by field."""
    calls = [
        ("GetClusterInfo", pb.GetClusterInfoRequest()),
        ("Heartbeat", pb.HeartbeatRequest(node_id="x", term=1)),
        ("JoinCluster", pb.JoinClusterRequest(node=pb.NodeInfo(node_id="n2", address="h:1"))),
        ("LeaveCluster", pb.LeaveClusterRequest(node_id="n2")),
        ("AppendEntries", pb.AppendEntriesRequest(term=3, leader_id="n2")),
        ("RequestVote", pb.RequestVoteRequest(term=5, candidate_id="n2")),
        ("InstallSnapshot", pb.InstallSnapshotRequest(term=5, leader_id="n2")),
        ("MigrateShard", pb.MigrateShardRequest(shard_id=1, from_node="a", to_node="b")),
        ("RebalanceShards", pb.RebalanceShardsRequest()),
        ("GetShardInfo", pb.GetShardInfoRequest(shard_id=2)),
        ("Internal", pb.InternalRequest(src_node="n2", method="ping", payload=b"x")),
    ]
    for method, req in calls:
        a, b = both["torch"].call(method, req), both["jax"].call(method, req)
        assert type(a) is type(b)
        assert a == b, (method, a, b)
    info = both["torch"].call("GetClusterInfo", pb.GetClusterInfoRequest())
    assert info.cluster_id == "standalone" and len(info.members) == 1
    join = both["torch"].call("JoinCluster", calls[2][1])
    assert not join.accepted and "cluster mode" in join.error


def test_grpc_error_paths_match_jax(both):
    bad = [pb.Point(id="bad", vector=pb.Vector(values=[1.0]))]
    a, b = both["torch"].client.upsert_points(bad), both["jax"].client.upsert_points(bad)
    assert a.upserted == b.upserted == 0 and "dim" in a.error and "dim" in b.error
    a = both["torch"].client.search([0.0] * DIM, filter_sql="x ===")
    b = both["jax"].client.search([0.0] * DIM, filter_sql="x ===")
    assert a.error and b.error and not a.results


# -- REST: every route, the same requests to both servers --------------------------------


def _assert_is_stored(body, doc):
    """A GET /api/v1/documents/<id> body against the stored document."""
    want = doc.to_dict()
    vec = np.asarray(want.pop("vector"), np.float32)
    got_vec = np.asarray(body.pop("vector"), np.float32)
    assert got_vec.shape == vec.shape and np.array_equal(got_vec, vec)
    assert body == json.loads(json.dumps(want))


def test_rest_routes_match_jax(both):
    vecs = corpus()
    pts = [{"id": f"r{i}", "vector": vecs[i].tolist(),
            "metadata": {"odd": bool(i % 2), "n": i}} for i in range(ROWS)]

    def each(method, path, body=None):
        out = {name: _req(method, s.base + path, body) for name, s in both.items()}
        assert out["torch"][0] == out["jax"][0], (path, out)
        return out["torch"], out["jax"]

    (code, a), (_, b) = each("POST", "/api/v1/vectors", {"points": pts})
    assert code == 200 and a == b and a["upserted"] == ROWS
    (code, a), (_, b) = each("POST", "/api/v1/vectors", {"id": "one", "vector": vecs[0].tolist()})
    assert code == 200 and a == b == {"upserted": 1, "ids": ["one"]}
    (code, a), (_, b) = each("POST", "/api/v1/documents",
                             {"id": "doc-a", "content": "hello tpu world"})
    assert code == 200 and a == b == {"id": "doc-a"}
    (code, a), (_, b) = each("POST", "/api/v1/documents", {
        "id": "doc-v", "content": "a vector of its own", "vector": vecs[1].tolist()})
    assert code == 200 and a == b == {"id": "doc-v"}
    (code, a), (_, b) = each("POST", "/api/v1/documents/batch", {"documents": [
        {"id": "doc-b", "content": "pasta recipe"},
        {"id": "doc-c", "content": "tpu pods and pasta", "metadata": {"odd": True}}]})
    assert code == 200 and a == b == {"ids": ["doc-b", "doc-c"]}

    # GET /api/v1/documents/doc-a: the embedder's vector is an ndarray. The
    # port's route answers with the stored document; the reference's
    # json.dumps refuses it and answers 500 (ROADMAP C.4, fixed in the port)
    code, a = _req("GET", both["torch"].base + "/api/v1/documents/doc-a")
    assert code == 200
    _assert_is_stored(a, both["torch"].db.get_document("doc-a"))
    assert _req("GET", both["jax"].base + "/api/v1/documents/doc-a")[0] == 500
    for path in ("/api/v1/vectors/r7", "/api/v1/vectors/zzz", "/api/v1/documents/doc-v",
                 "/api/v1/documents/zzz"):
        (code, a), (_, b) = each("GET", path)
        assert code == (404 if path.endswith("zzz") else 200)
        if "vector" in a:
            np.testing.assert_allclose(a.pop("vector"), b.pop("vector"), atol=1e-6)
        if code == 200 and "/documents/" in path:
            for doc in (a, b):
                doc.pop("created_at", None)
                doc.pop("updated_at", None)
        assert a == b, (path, a, b)

    queries = np.concatenate([vecs[:4] + 0.1 * corpus(4, seed=1), corpus(4, seed=2)])
    for q in queries.tolist():
        for extra in ({}, {"limit": 3, "with_payload": False}, {"filter_sql": "odd = true"},
                      {"score_threshold": 0.2}, {"host_rescore": 16}, {"host_rescore": 0}):
            (code, a), (_, b) = each("POST", "/api/v1/search",
                                     {"mode": "vector", "vector": q, **extra})
            assert code == 200 and a["results"]
            assert_same_results(a["results"], b["results"])
    for body in ({"mode": "text", "query": "tpu", "limit": 5},
                 {"mode": "text", "query": "tpu", "filter_sql": "odd = true"},
                 {"mode": "hybrid", "query": "pasta", "limit": 4}):
        (code, a), (_, b) = each("POST", "/api/v1/search", body)
        assert code == 200 and a["results"]
        assert_same_results(a["results"], b["results"])
    (code, a), (_, b) = each("POST", "/api/v1/search", {"mode": "vector", "vector": [1.0]})
    assert code == 500 and "error" in a and "error" in b

    (code, a), (_, b) = each("POST", "/api/v1/heartbeat", {"node_id": "x"})
    assert code == 200 and a == b == {"ok": True}
    for path in ("/api/v1/replicate", "/api/v1/shards/migrate", "/raft/vote", "/cluster/join"):
        (code, a), (_, b) = each("POST", path, {})
        assert code == 400 and a == b
    (code, a), (_, b) = each("GET", "/cluster/info")
    assert code == 200 and a == b == {"cluster_id": "standalone", "members": []}

    for path in ("/api/v1/vectors/r7", "/api/v1/vectors/r7", "/api/v1/documents/doc-b",
                 "/api/v1/nope/x"):
        (code, a), (_, b) = each("DELETE", path)
        assert a == b
    assert [_req("GET", both["torch"].base + p)[0]
            for p in ("/api/v1/vectors/r7", "/api/v1/documents/doc-b")] == [404, 404]

    for path in ("/health", "/api/v1/health"):
        (code, a), (_, b) = each("GET", path)
        assert code == 200 and a["status"] == b["status"] == "healthy"
    (code, a), (_, b) = each("GET", "/api/v1/stats")
    assert code == 200
    for key in ("document_count", "index_size", "index_kind"):
        assert a[key] == b[key], key
    assert a["document_count"] == ROWS + 1 + 4 - 2
    (code, a), (_, b) = each("GET", "/metrics")
    assert code == 200 and "grape_vector_db_queries_total" in a
    for method, path in (("GET", "/api/v1/nope"), ("POST", "/api/v1/nope"),
                         ("DELETE", "/nope")):
        (code, a), (_, b) = each(method, path, {} if method == "POST" else None)
        assert code == 404 and a == b


def test_rest_document_route_answers_store_decoded_vector(tmp_path):
    """ROADMAP C.4 for a store-decoded document: after a reopen the file
    store hands the record's vector back as an ndarray, and the route answers
    with the stored document."""
    cfg = torch_pkg.VectorDbConfig(vector_dimension=DIM)
    vec = corpus(1)[0]
    db = torch_pkg.VectorDatabase(path=str(tmp_path / "db"), config=cfg, device="cpu")
    db.batch_add_documents([torch_pkg.Document(id="kept", content="from disk",
                                               vector=vec.tolist(), metadata={"n": 1})])
    db.close()
    db = torch_pkg.VectorDatabase(path=str(tmp_path / "db"), config=cfg, device="cpu")
    rest = trest.RestServer(db, port=0)
    host, port = rest.start()
    try:
        doc = db.get_document("kept")
        assert isinstance(doc.vector, np.ndarray)
        code, body = _req("GET", f"http://{host}:{port}/api/v1/documents/kept")
        assert code == 200
        np.testing.assert_array_equal(np.asarray(body["vector"], np.float32), vec)
        _assert_is_stored(body, doc)
    finally:
        rest.stop()
        db.close()


# -- tests/test_server.py's cases through the port ----------------------------------------


def test_grpc_batched_concurrent_search():
    """Concurrent unfiltered SearchVectors RPCs share device batches through
    the micro-batching executor."""
    s = Served("torch")
    try:
        vecs = corpus(20)
        s.client.upsert_points(points(vecs, prefix="b"))

        def one(i):
            r = s.call("SearchVectors", pb.SearchVectorsRequest(
                query=pb.Vector(values=vecs[i].astype(float)), limit=3, with_payload=False))
            return r.results[0].id

        with concurrent.futures.ThreadPoolExecutor(max_workers=12) as ex:
            got = list(ex.map(one, range(12)))
        assert got == [f"b{i}" for i in range(12)]
        assert s.servicer.batcher.queries_run >= 12
        assert s.servicer.batcher.batches_run < s.servicer.batcher.queries_run
        assert s.servicer.batcher.pad_to is None
    finally:
        s.stop()


def test_grpc_api_key_enforcement():
    from grape_vector_db_tpu_torch.services.enterprise import Role

    db = small_db("torch")
    auth = db.enable_enterprise()
    writer = auth.create_api_key("w", Role.DATA_MANAGER)
    reader = auth.create_api_key("r", Role.READ_ONLY_USER)
    s = Served("torch", db=db)
    channel = grpc.insecure_channel(s.address)
    try:
        def call(method, req_msg, resp_cls, key=None):
            stub = channel.unary_unary(
                f"/{tgrpc.SERVICE_NAME}/{method}",
                request_serializer=type(req_msg).SerializeToString,
                response_deserializer=resp_cls.FromString)
            md = (("x-api-key", key),) if key else ()
            return stub(req_msg, metadata=md, timeout=10)

        pt = pb.Point(id="a1", vector=pb.Vector(values=[1.0] * DIM))
        r = call("UpsertVector", pb.UpsertVectorRequest(points=[pt]), pb.UpsertVectorResponse)
        assert "unauthorized" in r.error and r.upserted == 0
        r = call("UpsertVector", pb.UpsertVectorRequest(points=[pt]), pb.UpsertVectorResponse,
                 key=reader.key)
        assert "unauthorized" in r.error
        r = call("DeleteVector", pb.DeleteVectorRequest(ids=["a1"]), pb.DeleteVectorResponse,
                 key=reader.key)
        assert "unauthorized" in r.error
        r = call("UpsertVector", pb.UpsertVectorRequest(points=[pt]), pb.UpsertVectorResponse,
                 key=writer.key)
        assert r.upserted == 1
        r = call("SearchVectors", pb.SearchVectorsRequest(
            query=pb.Vector(values=[1.0] * DIM), limit=1), pb.SearchVectorsResponse)
        assert "unauthorized" in r.error
        r = call("SearchVectors", pb.SearchVectorsRequest(
            query=pb.Vector(values=[1.0] * DIM), limit=1), pb.SearchVectorsResponse,
            key=reader.key)
        assert not r.error and r.results[0].id == "a1"
    finally:
        channel.close()
        s.stop()


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from grape_vector_db_tpu_torch.testing.certs import make_test_certs

    return make_test_certs(str(tmp_path_factory.mktemp("certs")), with_client=True)


def test_grpc_tls_roundtrip_and_insecure_rejected(certs):
    from grape_vector_db_tpu_torch.config import TlsConfig

    db = small_db("torch")
    server, port, _ = tgrpc.build_grpc_server(db, port=0, tls=TlsConfig(
        enabled=True, cert_path=certs["cert"], key_path=certs["key"]))
    server.start()
    try:
        client = tgrpc.VectorDbClient(f"127.0.0.1:{port}", tls=TlsConfig(
            enabled=True, ca_path=certs["ca"], target_name_override="localhost"))
        vec = corpus(1)[0].astype(float)
        resp = client.upsert_points([pb.Point(id="t1", vector=pb.Vector(values=vec))])
        assert resp.upserted == 1 and not resp.error
        assert client.search(vec.tolist(), limit=1).results[0].id == "t1"
        client.close()
        bad = tgrpc.VectorDbClient(f"127.0.0.1:{port}", timeout_s=2.0)
        with pytest.raises(grpc.RpcError):
            bad.search([0.0] * DIM, limit=1)
        bad.close()
    finally:
        server.stop(grace=0)
        db.close()


def test_grpc_mtls_requires_client_cert(certs):
    from grape_vector_db_tpu_torch.config import TlsConfig

    db = small_db("torch")
    server, port, _ = tgrpc.build_grpc_server(db, port=0, tls=TlsConfig(
        enabled=True, cert_path=certs["cert"], key_path=certs["key"], ca_path=certs["ca"],
        require_client_auth=True))
    server.start()
    try:
        good = tgrpc.VectorDbClient(f"127.0.0.1:{port}", tls=TlsConfig(
            enabled=True, ca_path=certs["ca"], cert_path=certs["client_cert"],
            key_path=certs["client_key"], require_client_auth=True,
            target_name_override="localhost"))
        assert not good.search([0.0] * DIM, limit=1).error
        good.close()
        anon = tgrpc.VectorDbClient(f"127.0.0.1:{port}", timeout_s=2.0, tls=TlsConfig(
            enabled=True, ca_path=certs["ca"], target_name_override="localhost"))
        with pytest.raises(grpc.RpcError):
            anon.search([0.0] * DIM, limit=1)
        anon.close()
        with pytest.raises(ValueError, match="ca_path"):
            tgrpc.server_credentials(TlsConfig(enabled=True, cert_path=certs["cert"],
                                               key_path=certs["key"],
                                               require_client_auth=True))
    finally:
        server.stop(grace=0)
        db.close()


def test_rest_tls(certs):
    import ssl

    from grape_vector_db_tpu_torch.config import TlsConfig

    db = small_db("torch")
    db.batch_add_documents([torch_pkg.Document(id="r1", content="hello tls",
                                               vector=corpus(1)[0].tolist())])
    srv = trest.RestServer(db, port=0, tls=TlsConfig(
        enabled=True, cert_path=certs["cert"], key_path=certs["key"]))
    _, port = srv.start()
    try:
        ctx = ssl.create_default_context(cafile=certs["ca"])
        with urllib.request.urlopen(f"https://127.0.0.1:{port}/health", context=ctx,
                                    timeout=5) as r:
            assert json.loads(r.read())["status"] == "healthy"
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
    finally:
        srv.stop()
        db.close()


def clustered(rng, n_per, dim, scale, noise):
    centers = rng.standard_normal((4, dim)).astype(np.float32) * scale
    pts = np.concatenate([c + noise * rng.standard_normal((n_per, dim)).astype(np.float32)
                          for c in centers])
    return centers, pts


def test_grpc_search_ef_reaches_ivf(rng):
    """The wire-level ef reaches the port's IVF engine as a per-request
    nprobe override: at ef = nlist a query between two clusters sees every
    list, so its answer is the exact one, and a wider set than nprobe = 1's."""
    db = small_db("torch", cache=False, kind="ivf", nlist=4, nprobe=1, initial_capacity=1024)
    centers, pts = clustered(rng, 30, DIM, 4, 0.4)
    db.batch_add_documents([torch_pkg.Document(id=f"d{i}", content=f"c{i}",
                                               vector=pts[i].tolist())
                            for i in range(len(pts))])
    db.index.optimize()
    s = Served("torch", db=db)
    try:
        q = (centers[0] + centers[1]) / 2.0
        narrow = s.client.search(q.astype(float).tolist(), limit=20)
        wide = s.client.search(q.astype(float).tolist(), limit=20, ef=4)
        assert not narrow.error and not wide.error
        assert len(wide.results) >= len(narrow.results)
        vn = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        want = (vn @ (q / np.linalg.norm(q))).astype(np.float64)
        top = np.argsort(-want)[:20]
        assert_hits_match([[(r.id, r.score) for r in wide.results]],
                          [[(f"d{i}", want[i]) for i in top]], TOL)
    finally:
        s.stop()


def test_grpc_search_host_rescore_reaches_engine(rng):
    """SearchVectorsRequest.host_rescore reaches the port's query engine: a
    codes-only int4 index misorders tight clusters on the device, and the
    wire knob restores the exact order from the store's embeddings."""
    dim = 64
    db = small_db("torch", dim=dim, cache=False, kind="ivf_int4", nlist=4, nprobe=4,
                  initial_capacity=1024, int8_rescore=0, ivf_int8_keep_bf16=False)
    _, pts = clustered(rng, 50, dim, 2, 0.05)
    db.batch_add_documents([torch_pkg.Document(id=f"d{i}", content=f"c{i}",
                                               vector=pts[i].tolist())
                            for i in range(len(pts))])
    s = Served("torch", db=db)
    try:
        vn = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        ok_raw = ok_resc = 0
        for qi in (3, 57, 101, 155):
            want = {f"d{j}" for j in np.argsort(-(vn[qi] @ vn.T))[:5]}
            raw = s.client.search(pts[qi].astype(float).tolist(), limit=5)
            resc = s.client.search(pts[qi].astype(float).tolist(), limit=5, host_rescore=192)
            assert not raw.error and not resc.error
            ok_raw += len({r.id for r in raw.results} & want)
            ok_resc += len({r.id for r in resc.results} & want)
        assert ok_resc >= 19, (ok_raw, ok_resc)
        assert ok_resc > ok_raw, (ok_raw, ok_resc)
    finally:
        s.stop()


def test_serve_subprocess_end_to_end(tmp_path):
    """``python -m grape_vector_db_tpu_torch.cli serve --device cpu`` in a
    subprocess, over both protocols, then stopped by an interrupt: the
    database closes and a reopen finds what was written."""
    import signal

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    data = str(tmp_path / "srv")
    proc = subprocess.Popen(
        [sys.executable, "-m", "grape_vector_db_tpu_torch.cli", "serve", "--host",
         "127.0.0.1", "--grpc-port", "0", "--rest-port", "0", "--data-dir", data,
         "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        seen, line = [], ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            line = proc.stdout.readline()
            seen.append(line)
            if "serving:" in line:
                break
        m = re.search(r"grpc=:(\d+) rest=([\d.]+):(\d+)", line)
        assert m, f"no serving banner: {''.join(seen)[-2000:]!r}"
        client = tgrpc.VectorDbClient(f"127.0.0.1:{m.group(1)}")
        resp = client.call("AddDocument", pb.AddDocumentRequest(documents=[
            pb.Document(id="sub-1", content="served from a subprocess")]))
        assert list(resp.ids) == ["sub-1"]
        assert client.call("GetDocument", pb.GetDocumentRequest(id="sub-1")).found
        client.close()
        code, health = _req("GET", f"http://{m.group(2)}:{m.group(3)}/health")
        assert code == 200 and health["status"] == "healthy"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) is not None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    cfg = torch_pkg.VectorDbConfig()
    db = torch_pkg.VectorDatabase(path=data, config=cfg, device="cpu")
    try:
        assert db.get_document("sub-1") is not None
    finally:
        db.close()


@pytest.mark.parametrize("flags", [["--node-id", "n1", "--peers", "n1=127.0.0.1:1"],
                                   ["--peers", "n1=127.0.0.1:1"],
                                   ["--shard-count", "16"], ["--replica-count", "1"]])
def test_serve_cluster_mode_raises(flags, monkeypatch):
    """The cluster-mode flags no longer raise (they did until the distributed
    tier was ported): ``serve`` parses them as the reference's CLI does, with
    its defaults (16 shards, 2 replicas), and hands them to ``cmd_serve``."""
    from grape_vector_db_tpu import cli as jax_cli
    from grape_vector_db_tpu_torch import cli as torch_cli

    seen = {}
    for name, mod in (("jax", jax_cli), ("torch", torch_cli)):
        monkeypatch.setattr(mod, "cmd_serve", lambda args, name=name: seen.setdefault(
            name, vars(args)))
        mod.main(["serve", "--grpc-port", "0", "--rest-port", "0", *flags])
    assert seen["torch"].pop("device") == "cuda"
    assert {k: v for k, v in seen["torch"].items() if k != "fn"} == {
        k: v for k, v in seen["jax"].items() if k != "fn"}
    assert seen["torch"]["shard_count"] == 16
    assert seen["torch"]["replica_count"] == (1 if "--replica-count" in flags else 2)

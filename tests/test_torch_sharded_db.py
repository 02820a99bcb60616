"""The sharded index kinds through the port's product API, against the JAX
package's, on the CPU: the counterpart of tests/test_sharded_db.py.

The JAX databases build their sharded indexes over the 8 virtual CPU devices
of tests/conftest.py. The port's mesh comes from
``parallel.mesh.local_devices``, which these tests patch to a host of 8 (or
4) CPU devices, as the same one CPU repeated. Both take the same documents
from a seed. IVF kinds probe every list (nprobe = nlist), so the partition,
whose k-means start differs across engines, does not decide an answer.
Answers compare as id sets with the near-tie guard; scores within 1e-5 (f32
storage) and 3e-3 for the quantized and projected kinds, whose rescore
candidates come from code scores summed in another order
(tests/torch_parity.py).
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu.config import VectorDbConfig as JaxConfig
from grape_vector_db_tpu.db import VectorDatabase as JaxDatabase
from grape_vector_db_tpu.db import build_index as jax_build_index
from grape_vector_db_tpu.types import Condition as JaxCondition
from grape_vector_db_tpu.types import Document as JaxDocument
from grape_vector_db_tpu.types import Filter as JaxFilter
from grape_vector_db_tpu.types import HybridSearchRequest as JaxHybrid
from grape_vector_db_tpu.types import SearchRequest as JaxSearchRequest
from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.db import VectorDatabase, build_index
from grape_vector_db_tpu_torch.parallel import mesh as pmesh
from grape_vector_db_tpu_torch.types import (Condition, Document, Filter, HybridSearchRequest,
                                             SearchRequest)
from torch_parity import assert_hits_match

torch.set_num_threads(2)

DIM = 64
F32 = 1e-5
CODES = 3e-3


@pytest.fixture
def host8(monkeypatch):
    """This host as one with 8 devices: the one CPU, 8 times."""
    monkeypatch.setattr(pmesh, "local_devices", lambda device="cuda": [torch.device("cpu")] * 8)


def make_cfg(cls, kind: str, **index_kw):
    cfg = cls()
    cfg.vector_dimension = DIM
    cfg.index.kind = kind
    cfg.index.initial_capacity = 1024
    cfg.index.nlist = 8
    cfg.index.nprobe = 8
    cfg.device.storage_dtype = "float32"
    cfg.cache.enabled = False
    for k, v in index_kw.items():
        setattr(cfg.index, k, v)
    return cfg


def make_docs(cls, vecs):
    return [cls(id=f"doc-{i}", content=f"document number {i} about topic {i % 5}",
                vector=vecs[i].tolist(), metadata={"topic": i % 5})
            for i in range(len(vecs))]


def pair(kind, **index_kw):
    return (JaxDatabase(config=make_cfg(JaxConfig, kind, **index_kw)),
            VectorDatabase(config=make_cfg(VectorDbConfig, kind, **index_kw), device="cpu"))


def rows(points):
    return [(p.document.id, p.score) if hasattr(p, "document") else (p.id, p.score)
            for p in points]


def tol_of(kind):
    return F32 if kind in ("sharded_flat", "sharded_ivf") else CODES


@pytest.mark.parametrize("kind", ["sharded_flat", "sharded_ivf", "sharded_ivf_int8",
                                  "sharded_ivf_int4"])
def test_db_sharded_kind_end_to_end(kind, rng, host8):
    jdb, tdb = pair(kind)
    vecs = rng.standard_normal((200, DIM)).astype(np.float32)
    tol = tol_of(kind)
    for db, doc in ((jdb, JaxDocument), (tdb, Document)):
        db.batch_add_documents(make_docs(doc, vecs))
    assert tdb.stats().index_kind == kind and tdb.stats().index_size == 200
    assert tdb.index.n_shards == 8
    if kind == "sharded_flat":
        assert tdb.index._id_to_slot == jdb.index._id_to_slot

    def both(call_t, call_j):
        got, want = call_t(tdb), call_j(jdb)
        assert_hits_match([rows(got)], [rows(want)], tol)
        return got

    res = both(lambda db: db.search(SearchRequest(vector=vecs[7].tolist(), limit=5)),
               lambda db: db.search(JaxSearchRequest(vector=vecs[7].tolist(), limit=5)))
    assert res[0].document.id == "doc-7"
    got = tdb.vector_search_batch(vecs[:4], 3)
    assert_hits_match([rows(r) for r in got], [rows(r) for r in jdb.vector_search_batch(
        vecs[:4], 3)], tol)
    assert got[0][0].id == "doc-0"
    for db in (jdb, tdb):
        db.batch_delete_documents(["doc-7"])
    res = both(lambda db: db.search(SearchRequest(vector=vecs[7].tolist(), limit=5)),
               lambda db: db.search(JaxSearchRequest(vector=vecs[7].tolist(), limit=5)))
    assert all(r.document.id != "doc-7" for r in res)
    tdb.add_document(Document(id="doc-3", content="moved", vector=vecs[100].tolist()))
    jdb.add_document(JaxDocument(id="doc-3", content="moved", vector=vecs[100].tolist()))
    res = both(lambda db: db.search(SearchRequest(vector=vecs[100].tolist(), limit=2)),
               lambda db: db.search(JaxSearchRequest(vector=vecs[100].tolist(), limit=2)))
    assert {r.document.id for r in res} == {"doc-3", "doc-100"}


def test_db_sharded_filtered_search(rng, host8):
    jdb, tdb = pair("sharded_flat")
    vecs = rng.standard_normal((120, DIM)).astype(np.float32)
    jdb.batch_add_documents(make_docs(JaxDocument, vecs))
    tdb.batch_add_documents(make_docs(Document, vecs))
    res = tdb.search(SearchRequest(vector=vecs[2].tolist(), limit=10,
                                   filter=Filter(must=[Condition("topic", "eq", 2)])))
    want = jdb.search(JaxSearchRequest(vector=vecs[2].tolist(), limit=10,
                                       filter=JaxFilter(must=[JaxCondition("topic", "eq", 2)])))
    assert res and res[0].document.id == "doc-2"
    assert all(r.document.metadata["topic"] == 2 for r in res)
    assert_hits_match([rows(res)], [rows(want)], F32)


def test_db_sharded_hybrid_and_rebuild(rng, host8):
    jdb, tdb = pair("sharded_ivf")
    vecs = rng.standard_normal((150, DIM)).astype(np.float32)
    jdb.batch_add_documents(make_docs(JaxDocument, vecs))
    tdb.batch_add_documents(make_docs(Document, vecs))
    got = tdb.hybrid_search(HybridSearchRequest(query="topic 3", dense_vector=vecs[3].tolist(),
                                                limit=5))
    want = jdb.hybrid_search(JaxHybrid(query="topic 3", dense_vector=vecs[3].tolist(), limit=5))
    assert got
    assert_hits_match([rows(got)], [rows(want)], F32)
    assert tdb.rebuild_index() == jdb.rebuild_index() == 150
    res = tdb.search(SearchRequest(vector=vecs[11].tolist(), limit=3))
    assert res and res[0].document.id == "doc-11"
    assert_hits_match([rows(res)], [rows(jdb.search(JaxSearchRequest(
        vector=vecs[11].tolist(), limit=3)))], F32)


def test_db_sharded_snapshot_roundtrip(tmp_path, rng, host8):
    jdb, tdb = pair("sharded_flat")
    vecs = rng.standard_normal((64, DIM)).astype(np.float32)
    jdb.batch_add_documents(make_docs(JaxDocument, vecs))
    tdb.batch_add_documents(make_docs(Document, vecs))
    snap = str(tmp_path / "idx.snap")
    assert tdb.save_index(snap)["points"] == 64
    jdb.save_index(str(tmp_path / "jax.snap"))
    t2 = VectorDatabase(config=make_cfg(VectorDbConfig, "sharded_flat"), device="cpu")
    j2 = JaxDatabase(config=make_cfg(JaxConfig, "sharded_flat"))
    t2.load_index(snap)
    j2.load_index(str(tmp_path / "jax.snap"))
    hits = t2.index.search(vecs[5], 3)
    assert hits and hits[0][0] == "doc-5"
    assert_hits_match([hits], [j2.index.search(vecs[5], 3)], F32)
    assert t2.index._id_to_slot == j2.index._id_to_slot


def test_sharded_flat_auto_grows_past_initial_capacity(rng, host8):
    jdb, tdb = pair("sharded_flat")
    vecs = rng.standard_normal((1500, DIM)).astype(np.float32)   # > 8 x 128
    jdb.batch_add_documents(make_docs(JaxDocument, vecs))
    tdb.batch_add_documents(make_docs(Document, vecs))
    assert tdb.stats().index_size == 1500
    assert tdb.index.shard_capacity == jdb.index.shard_capacity == 256
    assert tdb.index._id_to_slot == jdb.index._id_to_slot
    res = tdb.search(SearchRequest(vector=vecs[1400].tolist(), limit=3))
    assert res and res[0].document.id == "doc-1400"
    assert_hits_match([rows(res)], [rows(jdb.search(JaxSearchRequest(
        vector=vecs[1400].tolist(), limit=3)))], F32)


def test_auto_shard_upgrades_kind_on_multichip_host(host8):
    for kind, want in (("flat", "sharded_flat"), ("ivf_int8", "sharded_ivf_int8"),
                       ("binary", "binary")):
        cfgs = [make_cfg(JaxConfig, kind), make_cfg(VectorDbConfig, kind)]
        for cfg in cfgs:
            cfg.device.auto_shard = True
        assert build_index(cfgs[1], device="cpu").kind == jax_build_index(cfgs[0]).kind == want
    cfg = make_cfg(VectorDbConfig, "flat")
    cfg.device.auto_shard = True
    assert build_index(cfg, device="cpu").n_shards == 8


def test_sharded_2d_replica_mesh_through_db(rng, host8):
    for kind, n in (("sharded_flat", 96), ("sharded_ivf_int8", 160)):
        cfgs = [make_cfg(JaxConfig, kind), make_cfg(VectorDbConfig, kind)]
        for cfg in cfgs:
            cfg.device.n_replicas = 2
        jdb, tdb = JaxDatabase(config=cfgs[0]), VectorDatabase(config=cfgs[1], device="cpu")
        assert tdb.index.replica_axis == "replica"
        assert tdb.index.n_shards == 4 and tdb.index.n_replicas == 2
        vecs = rng.standard_normal((n, DIM)).astype(np.float32)
        jdb.batch_add_documents(make_docs(JaxDocument, vecs))
        tdb.batch_add_documents(make_docs(Document, vecs))
        q = vecs[9:14] + 0.01
        got = tdb.vector_search_batch(q, 5)    # 5 rows: the lanes split 3 + 2
        assert [r[0].id for r in got] == [f"doc-{i}" for i in range(9, 14)]
        assert_hits_match([rows(r) for r in got],
                          [rows(r) for r in jdb.vector_search_batch(q, 5)], tol_of(kind))


def test_embedded_db_sharded_kind(tmp_path, rng, host8):
    from grape_vector_db_tpu_torch.config import EmbeddedConfig
    from grape_vector_db_tpu_torch.embedded import EmbeddedVectorDB

    ecfg = EmbeddedConfig(data_dir=str(tmp_path / "emb"))
    ecfg.db = make_cfg(VectorDbConfig, "sharded_flat")
    emb = EmbeddedVectorDB(config=ecfg, device="cpu")
    try:
        vecs = rng.standard_normal((80, DIM)).astype(np.float32)
        emb.db.batch_add_documents(make_docs(Document, vecs))
        res = emb.db.search(SearchRequest(vector=vecs[17].tolist(), limit=3))
        assert res and res[0].document.id == "doc-17"
        assert emb.db.stats().index_kind == "sharded_flat"
        assert emb.db.index.n_shards == 8
    finally:
        emb.close()


def test_cluster_node_serves_local_mesh_index(monkeypatch):
    """A cluster node on a host of several devices (4 here) serves the
    mesh-sharded index (``auto_shard``, which ``ClusterNode`` turns on), and
    the cluster answers exactly."""
    from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
    from grape_vector_db_tpu_torch.distributed.raft import RaftConfig
    from grape_vector_db_tpu_torch.distributed.types import ClusterConfig, ConsistencyLevel

    monkeypatch.setattr(pmesh, "local_devices", lambda device="cuda": [torch.device("cpu")] * 4)
    ccfg = ClusterConfig(shard_count=8, replica_count=2, consistency=ConsistencyLevel.SESSION,
                         heartbeat_interval_s=0.2, election_timeout_ms=(80, 160),
                         raft_heartbeat_ms=25.0)
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 256
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0)
    svc = ClusterService(["node-0", "node-1", "node-2"], cluster_config=ccfg, db_config=dcfg,
                         raft_config=rcfg, device="cpu")
    svc.start()
    try:
        for node in svc.nodes.values():
            assert node.db.index.kind == "sharded_flat" and node.db.index.n_shards == 4
        rng = np.random.default_rng(3)
        x = rng.standard_normal((60, 16)).astype(np.float32)
        docs = [Document(id=f"doc-{i}", content=f"body {i}", vector=x[i].tolist())
                for i in range(60)]
        assert svc.upsert(docs) == 60
        hits = svc.any_node().search(docs[13].vector, k=3)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        want = np.argsort(-(xn @ xn[13]))[:3]
        assert [h[0] for h in hits] == [f"doc-{i}" for i in want]
        np.testing.assert_allclose([h[1] for h in hits], (xn @ xn[13])[want], atol=1e-5)
    finally:
        svc.stop()


@pytest.mark.parametrize("kind", ["sharded_ivf_int8_proj", "sharded_ivf_int4_proj"])
def test_sharded_projected_capacity_kind(rng, host8, kind):
    cfgs = [make_cfg(JaxConfig, kind, proj_dim=128), make_cfg(VectorDbConfig, kind, proj_dim=128)]
    for cfg in cfgs:
        cfg.vector_dimension = 256
    jdb, tdb = JaxDatabase(config=cfgs[0]), VectorDatabase(config=cfgs[1], device="cpu")
    spec = (1.0 + np.arange(256)) ** -0.5
    vecs = (rng.standard_normal((240, 256)) * spec[None, :]).astype(np.float32)
    jdb.batch_add_documents([JaxDocument(id=f"p{i}", content=f"c{i}", vector=vecs[i])
                             for i in range(240)])
    tdb.batch_add_documents([Document(id=f"p{i}", content=f"c{i}", vector=vecs[i])
                             for i in range(240)])
    assert tdb.stats().index_kind == kind
    assert tdb.index.n_shards == 8 and tdb.index.proj_dim == 128
    for q in (vecs[13], vecs[100]):
        res = tdb.search(SearchRequest(vector=q.tolist(), limit=3))
        assert_hits_match([rows(res)], [rows(jdb.search(JaxSearchRequest(
            vector=q.tolist(), limit=3)))], CODES)
    assert tdb.search(SearchRequest(vector=vecs[13].tolist(), limit=3))[0].document.id == "p13"
    tdb.batch_delete_documents(["p13"])
    res = tdb.search(SearchRequest(vector=vecs[13].tolist(), limit=3))
    assert all(r.document.id != "p13" for r in res)

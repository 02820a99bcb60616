"""The scenarios of tests/test_grpc_cluster.py on the PyTorch port (indexes on
the CPU), then a JAX package's ``GrpcTransport`` and a port node calling each
other's ``Internal`` RPC, and ROADMAP C.6 (ndarray vectors on the wire).

Cross-process-shaped cluster test: 3 ClusterNodes talking over REAL gRPC
sockets (each node has its own GrpcTransport + gRPC server on localhost) —
the deployment topology the reference's HTTP stubs never delivered."""

import time

import numpy as np
import pytest

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.distributed.cluster import ClusterNode
from grape_vector_db_tpu_torch.distributed.raft import RaftConfig
from grape_vector_db_tpu_torch.distributed.types import ClusterConfig, ConsistencyLevel
from grape_vector_db_tpu_torch.server.cluster_adapter import GrpcClusterAdapter, GrpcTransport
from grape_vector_db_tpu_torch.server.grpc_server import build_grpc_server
from grape_vector_db_tpu_torch.types import Document


@pytest.fixture()
def grpc_cluster():
    node_ids = ["gn-0", "gn-1", "gn-2"]
    ccfg = ClusterConfig(shard_count=4, replica_count=2,
                         consistency=ConsistencyLevel.SESSION,
                         heartbeat_interval_s=0.3,
                         election_timeout_ms=(150, 300), raft_heartbeat_ms=50.0)
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 128
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(150, 300), heartbeat_ms=50.0,
                      tick_ms=10.0, rpc_timeout_s=1.0)

    transports = {nid: GrpcTransport() for nid in node_ids}
    nodes = {}
    servers = []
    for nid in node_ids:
        node = ClusterNode(
            node_id=nid, address="pending", seed_nodes=node_ids,
            transport=transports[nid], cluster_config=ccfg,
            db_config=dcfg, raft_config=rcfg, device="cpu",
        )
        adapter = GrpcClusterAdapter(node)
        server, port, _ = build_grpc_server(node.db, port=0, node=adapter,
                                            node_id=nid)
        server.start()
        node.address = f"127.0.0.1:{port}"
        nodes[nid] = node
        servers.append(server)
    # distribute the address book
    for t in transports.values():
        for nid, n in nodes.items():
            t.set_address(nid, n.address)
    for n in nodes.values():
        n.start()
    yield nodes
    for n in nodes.values():
        n.stop()
    for s in servers:
        s.stop(grace=0)


def test_grpc_cluster_election_and_data(grpc_cluster):
    nodes = grpc_cluster
    # raft over real sockets: single leader
    deadline = time.monotonic() + 10.0
    leader = None
    while time.monotonic() < deadline:
        leaders = [nid for nid, n in nodes.items() if n.raft.role.value == "leader"]
        if len(leaders) == 1:
            leader = leaders[0]
            break
        time.sleep(0.05)
    assert leader is not None, "no leader elected over gRPC"

    # membership via raft proposals over gRPC
    for n in nodes.values():
        n.join_cluster()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(len(n.members) == 3 for n in nodes.values()):
            break
        time.sleep(0.05)
    assert all(len(n.members) == 3 for n in nodes.values())

    # replicated writes + scatter-gather search over the wire
    rng = np.random.default_rng(0)
    docs = [Document(id=f"d{i}", content=f"c{i}",
                     vector=rng.standard_normal(16).astype(np.float32).tolist())
            for i in range(30)]
    any_node = next(iter(nodes.values()))
    assert any_node.upsert(docs) == 30
    total = sum(n.db.store.count() for n in nodes.values())
    assert total == 60  # replica_count=2
    hits = any_node.search(docs[11].vector, k=3)
    assert hits[0][0] == "d11" and hits[0][1] > 0.99


def test_grpc_session_token_roundtrip(grpc_cluster):
    """Session tokens over the wire: UpsertVector returns session_versions,
    SearchVectors with min_versions observes the write (read-your-writes
    through the public gRPC surface)."""
    from grape_vector_db_tpu_torch.server.grpc_server import (VectorDbClient,
                                                        build_grpc_server)
    from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb

    nodes = grpc_cluster
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(1 for n in nodes.values() if n.raft.role.value == "leader") == 1:
            break
        time.sleep(0.05)
    for n in nodes.values():
        n.join_cluster()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(len(n.members) == 3 for n in nodes.values()):
            break
        time.sleep(0.05)

    any_node = next(iter(nodes.values()))
    server, port, _ = build_grpc_server(any_node.db, port=0,
                                        cluster_node=any_node)
    server.start()
    client = VectorDbClient(f"127.0.0.1:{port}")
    try:
        rng = np.random.default_rng(5)
        pts = [pb.Point(id=f"p{i}",
                        vector=pb.Vector(values=rng.standard_normal(16)
                                         .astype(np.float32).tolist()))
               for i in range(12)]
        up = client.upsert_points(pts)
        assert up.upserted == 12 and not up.error
        assert dict(up.session_versions), "no session versions returned"
        resp = client.search(list(pts[4].vector.values), limit=3,
                             with_payload=False,
                             min_versions=dict(up.session_versions))
        assert not resp.error
        assert resp.results[0].id == "p4"
        # delete also returns versions
        dl = client.call("DeleteVector", pb.DeleteVectorRequest(ids=["p4"]))
        assert dl.deleted == 1 and dict(dl.session_versions)
    finally:
        client.close()
        server.stop(grace=0)


# -- the two packages on one wire ------------------------------------------------------------


def _served_node(name, node_id):
    """An unstarted single-member ClusterNode of package ``name`` behind its
    package's gRPC server, holding 24 documents whose vectors the embedder
    made (ndarrays) and 24 given as lists."""
    if name == "torch":
        import grape_vector_db_tpu_torch as pkg
        from grape_vector_db_tpu_torch.distributed import cluster, transport, types
        from grape_vector_db_tpu_torch.server import cluster_adapter, grpc_server
        extra = {"device": "cpu"}
    else:
        import grape_vector_db_tpu as pkg
        from grape_vector_db_tpu.distributed import cluster, transport, types
        from grape_vector_db_tpu.server import cluster_adapter, grpc_server
        extra = {}
    dcfg = pkg.VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 128
    node = cluster.ClusterNode(
        node_id=node_id, address="pending", seed_nodes=[node_id],
        transport=transport.InProcessTransport(),
        cluster_config=types.ClusterConfig(shard_count=4, replica_count=1),
        db_config=dcfg, **extra)
    rng = np.random.default_rng(1)
    node.db.batch_add_documents(
        [pkg.Document(id=f"e{i}", content=f"text {i}") for i in range(24)]
        + [pkg.Document(id=f"l{i}", content="", vector=rng.standard_normal(16).tolist())
           for i in range(24)])
    server, port, _ = grpc_server.build_grpc_server(
        node.db, port=0, node=cluster_adapter.GrpcClusterAdapter(node), node_id=node_id)
    server.start()
    return node, server, f"127.0.0.1:{port}"


def _transport(name, book):
    if name == "torch":
        from grape_vector_db_tpu_torch.server.cluster_adapter import GrpcTransport
    else:
        from grape_vector_db_tpu.server.cluster_adapter import GrpcTransport
    return GrpcTransport(address_book=book)


@pytest.fixture(scope="module")
def served():
    out = {name: _served_node(name, f"{name}-node") for name in ("torch", "jax")}
    yield out
    for node, server, _ in out.values():
        server.stop(grace=0)
        node.db.close()


@pytest.mark.parametrize("caller,callee", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch"), ("jax", "jax")])
def test_internal_rpc_crosses_packages(served, caller, callee):
    """One package's GrpcTransport calls the other's node through its
    ``Internal`` RPC: heartbeat and data_count answer as the callee's own
    handlers do."""
    node, _, address = served[callee]
    t = _transport(caller, {node.node_id: address})
    hb = t.call("probe", node.node_id, "heartbeat", {"node_id": "probe", "term": 0},
                timeout_s=5.0)
    assert hb == node._handle_rpc("heartbeat", {"node_id": "probe", "term": 0})
    assert hb["ok"] and hb["node_id"] == node.node_id
    for sid in range(4):
        got = t.call("probe", node.node_id, "data_count", {"shard_id": sid}, timeout_s=5.0)
        assert got == node._handle_rpc("data_count", {"shard_id": sid})
    assert sum(t.call("probe", node.node_id, "data_count", {"shard_id": sid},
                      timeout_s=5.0)["count"] for sid in range(4)) == 48


@pytest.mark.parametrize("caller", ["jax", "torch"])
def test_data_pull_of_ndarray_vectors(served, caller):
    """ROADMAP C.6: a shard pull (resync, migration) carries documents whose
    vectors the embedder made, which the store holds as ndarrays. msgpack
    refuses an ndarray, so the reference's node answers the pull with an
    error; the port's sends each vector as the list of floats msgpack packs,
    which a peer of either package reads back as the stored values."""
    from grape_vector_db_tpu.distributed.transport import TransportError as JErr
    from grape_vector_db_tpu_torch.distributed.transport import TransportError as TErr

    for callee in ("torch", "jax"):
        node, _, address = served[callee]
        t = _transport(caller, {node.node_id: address})
        pulled, refused = [], 0
        for sid in range(4):
            try:
                pulled += t.call("probe", node.node_id, "data_pull", {"shard_id": sid},
                                 timeout_s=5.0)["docs"]
            except (JErr, TErr) as e:
                assert callee == "jax" and "ndarray" in str(e), e
                refused += 1
        if callee == "jax":
            # every shard holds embedder-made documents: every pull fails
            assert refused == 4 and pulled == []
            continue
        assert refused == 0
        assert sorted(d["id"] for d in pulled) == sorted(node.db.store.iter_ids())
        for d in pulled:
            assert isinstance(d["vector"], list)
            want = node.db.store.get(d["id"]).embedding
            np.testing.assert_array_equal(np.asarray(d["vector"], np.float32),
                                          np.asarray(want, np.float32))

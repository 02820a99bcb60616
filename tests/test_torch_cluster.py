"""The scenarios of tests/test_cluster.py and tests/test_distributed.py on the
PyTorch port (every index on the CPU), then one deployment driven through
both packages: a 3-node, 8-shard, RF=2 cluster of 4,096 x 64 documents whose
placements and answers must agree, and agree with an exact oracle, before and
after a delete, a node failure, a partition and a runtime join and leave.

Full-cluster end-to-end tests: 3-node ClusterService with Raft metadata,
sharded replicated writes, scatter-gather search, node failure + failover —
the reference's disabled cluster_mode_tests / chaos tests, running for real.
(tests/test_distributed.py: shard routing, migration, replication policies,
failure detection/failover, load balancing, request routing.)"""

import time

import numpy as np
import pytest

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
from grape_vector_db_tpu_torch.distributed.failover import (
    FailureDetector,
    FailoverManager,
    RecoveryKind,
)
from grape_vector_db_tpu_torch.distributed.load_balancer import (
    IntelligentLoadBalancer,
    LoadBalancerConfig,
)
from grape_vector_db_tpu_torch.distributed.raft import RaftConfig
from grape_vector_db_tpu_torch.distributed.replication import (
    ReplicationManager,
    SyncPolicy,
)
from grape_vector_db_tpu_torch.distributed.request_router import ClusterAwareRequestRouter
from grape_vector_db_tpu_torch.distributed.shard import (
    ConsistentHashRing,
    ShardDataAccess,
    ShardManager,
    ShardMap,
)
from grape_vector_db_tpu_torch.distributed.types import (
    ClusterConfig,
    ConsistencyLevel,
    NodeInfo,
    NodeState,
    SessionToken,
)
from grape_vector_db_tpu_torch.errors import ReplicationError, UnavailableError
from grape_vector_db_tpu_torch.types import Document
from torch_parity import assert_hits_match


def make_service(n=3, consistency=ConsistencyLevel.SESSION, shard_count=8):
    ccfg = ClusterConfig(
        shard_count=shard_count,
        replica_count=2,
        consistency=consistency,
        heartbeat_interval_s=0.2,
        election_timeout_ms=(80, 160),
        raft_heartbeat_ms=25.0,
    )
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 256
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0)
    svc = ClusterService([f"node-{i}" for i in range(n)], cluster_config=ccfg,
                         db_config=dcfg, raft_config=rcfg, device="cpu")
    svc.start()
    return svc


def make_docs(n, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return [
        Document(id=f"doc-{i}", content=f"body {i}",
                 vector=rng.standard_normal(dim).astype(np.float32).tolist())
        for i in range(n)
    ]


@pytest.fixture()
def svc():
    s = make_service()
    yield s
    s.stop()


def test_cluster_boot_and_membership(svc):
    for n in svc.nodes.values():
        assert len(n.members) == 3
        assert all(i.primary_node for i in n.shard_map.shards.values())
    health = svc.any_node().cluster_health()
    assert health.status == "healthy" and health.healthy_nodes == 3


def test_replicated_write_and_scatter_search(svc):
    docs = make_docs(60)
    written = svc.upsert(docs)
    assert written == 60
    # replica_count=2: every doc exists on exactly 2 nodes
    total = sum(n.db.store.count() for n in svc.nodes.values())
    assert total == 120
    hits = svc.search(docs[7].vector, k=5)
    assert hits[0][0] == "doc-7"
    assert hits[0][1] > 0.99
    # no duplicate ids in merged results despite replication
    ids = [h[0] for h in hits]
    assert len(ids) == len(set(ids))


def test_cluster_delete(svc):
    docs = make_docs(20)
    svc.upsert(docs)
    assert svc.delete(["doc-3", "doc-4"]) == 2
    hits = svc.search(docs[3].vector, k=3)
    assert all(h[0] != "doc-3" for h in hits)


def test_node_failure_promotes_and_search_survives(svc):
    docs = make_docs(80)
    svc.upsert(docs)
    # hard-fail one non-leader node at the network level
    leader = svc.leader_node().node_id
    victim = next(nid for nid in svc.nodes if nid != leader)
    svc.sim.fail_node(victim)

    # detectors on live nodes must notice and raft-propagate the failure
    deadline = time.monotonic() + 8.0
    survivor_ids = [nid for nid in svc.nodes if nid != victim]
    ok = False
    while time.monotonic() < deadline:
        if all(
            svc.nodes[nid].members[victim].state.value == "failed"
            for nid in survivor_ids
        ):
            ok = True
            break
        time.sleep(0.05)
    assert ok, "victim never marked failed in replicated state"

    # after failover no shard lists the victim as primary on survivors' maps
    for nid in survivor_ids:
        for info in svc.nodes[nid].shard_map.shards.values():
            assert info.primary_node != victim

    # search from a survivor still finds everything (replicas cover the shards)
    node = svc.nodes[survivor_ids[0]]
    hits = node.search(docs[11].vector, k=3)
    assert hits and hits[0][0] == "doc-11"


def test_cluster_status_aggregation(svc):
    svc.upsert(make_docs(10))
    status = svc.status()
    assert len(status) == 3
    assert sum(1 for s in status.values() if s["raft"]["role"] == "leader") == 1
    assert all(s["docs"] >= 0 for s in status.values())


def test_node_recovery_propagates(svc):
    """Regression: recovery must propagate even when the one-shot proposal is
    lost to leader churn — the leader's reconcile loop re-proposes."""
    svc.upsert(make_docs(10))
    leader = svc.leader_node().node_id
    victim = next(nid for nid in svc.nodes if nid != leader)
    svc.sim.fail_node(victim)
    survivors = [nid for nid in svc.nodes if nid != victim]
    deadline = time.monotonic() + 8.0
    while time.monotonic() < deadline:
        if all(svc.nodes[n].members[victim].state.value == "failed" for n in survivors):
            break
        time.sleep(0.05)
    svc.sim.recover_node(victim)
    deadline = time.monotonic() + 8.0
    ok = False
    while time.monotonic() < deadline:
        if all(svc.nodes[n].members[victim].state.value == "healthy" for n in survivors):
            ok = True
            break
        time.sleep(0.05)
    assert ok, "recovery never propagated to replicated member state"


def test_strong_consistency_writes_via_raft():
    """STRONG mode: writes go through the raft log (VectorCommand semantics,
    raft.rs:96-112) and land exactly on each shard's owner nodes."""
    svc = make_service(consistency=ConsistencyLevel.STRONG)
    try:
        docs = make_docs(40)
        assert svc.upsert(docs) == 40
        # wait for apply on all nodes
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            total = sum(n.db.store.count() for n in svc.nodes.values())
            if total == 80:  # replica_count=2
                break
            time.sleep(0.05)
        assert total == 80
        # each doc lives exactly on its shard's owners (bounded wait: the
        # boot-churn absorbed copies are dropped by the relinquish sweep)
        any_node = svc.any_node()
        for d in docs[:10]:
            info = any_node.shard_map.shards[any_node.shard_map.shard_for_key(d.id)]
            owners = set(info.all_nodes())
            deadline = time.monotonic() + 10.0
            while True:
                holders = {nid for nid, n in svc.nodes.items()
                           if n.db.store.get(d.id) is not None}
                if holders == owners or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            assert holders == owners, (d.id, holders, owners)
        # search still works
        hits = svc.search(docs[5].vector, k=2)
        assert hits[0][0] == "doc-5"
        # raft-ordered delete
        svc.delete(["doc-5"])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if all(n.db.store.get("doc-5") is None for n in svc.nodes.values()):
                break
            time.sleep(0.05)
        assert all(n.db.store.get("doc-5") is None for n in svc.nodes.values())
    finally:
        svc.stop()


def test_six_node_cluster_double_failure():
    """SixNode-cluster intent from the reference's disabled suite
    (cluster_mode_tests): 6 nodes tolerate two simultaneous failures with
    replica_count=3 and keep serving."""
    svc = make_service(n=6, shard_count=12)
    # bump replication for this scenario
    try:
        docs = make_docs(60)
        svc.upsert(docs)
        leader = svc.leader_node().node_id
        victims = [nid for nid in svc.nodes if nid != leader][:2]
        for v in victims:
            svc.sim.fail_node(v)
        survivors = [nid for nid in svc.nodes if nid not in victims]
        deadline = time.monotonic() + 25.0
        while time.monotonic() < deadline:
            if all(
                svc.nodes[s].members[v].state.value == "failed"
                for s in survivors for v in victims
            ):
                break
            time.sleep(0.05)
        # failover done: no victim is primary anywhere on survivors' maps
        for s in survivors:
            for info in svc.nodes[s].shard_map.shards.values():
                assert info.primary_node not in victims
        # pick a doc whose shard had at least one surviving copy (with
        # replica_count=2 and 2 dead nodes, a shard can legitimately lose
        # both copies — that's a durability config choice, not a bug)
        node = svc.nodes[survivors[0]]
        target = next(
            d for d in docs
            if any(svc.nodes[s].db.store.get(d.id) is not None for s in survivors)
        )
        hits = node.search(target.vector, k=3)
        assert hits and hits[0][0] == target.id
    finally:
        svc.stop()


def test_session_token_read_your_writes(svc):
    """SESSION consistency with a real token: the upsert records primary
    shard versions; a token-carrying search observes the write."""
    from grape_vector_db_tpu_torch.distributed.types import SessionToken

    session = SessionToken()
    docs = make_docs(10, seed=42)
    svc.upsert(docs, session=session)
    assert session.versions, "upsert recorded no shard versions"
    hits = svc.search(docs[4].vector, k=3, session=session)
    assert hits[0][0] == "doc-4"
    # token survives wire round-trip
    rt = SessionToken.from_dict(session.to_dict())
    assert rt.versions == session.versions


def test_session_search_waits_for_lagging_replica(svc):
    """A replica behind the token's version must wait for the write to
    arrive (bounded), then serve; if it never arrives it reports the shard
    as stale instead of blocking forever."""
    import threading as _threading

    node = svc.any_node()
    node.session_wait_s = 1.5
    sid = 0
    key = next(f"k{i}" for i in range(1000)
               if node.shard_map.shard_for_key(f"k{i}") == sid)
    target = node.shard_versions.get(sid, 0) + 1

    def late_write():
        time.sleep(0.3)
        node._bump_shard_versions([key])

    t = _threading.Thread(target=late_write)
    t0 = time.monotonic()
    t.start()
    resp = node._rpc_data_search({
        "vector": [0.0] * 16, "k": 1, "min_versions": {str(sid): target},
    })
    waited = time.monotonic() - t0
    t.join()
    assert resp["stale"] == [] and 0.25 <= waited < 1.4

    # unreachable version: bounded wait, then reported stale
    node.session_wait_s = 0.3
    resp = node._rpc_data_search({
        "vector": [0.0] * 16, "k": 1,
        "min_versions": {str(sid): target + 100},
    })
    assert resp["stale"] == [sid]


def test_follower_strong_write_is_locally_applied_on_return():
    """ADVICE r1 (medium): a STRONG write coordinated by a NON-leader node
    forwards through client_command; on return the write must already be
    applied on the COORDINATOR (read-your-writes), and a session token built
    from its local versions must cover the write."""
    from grape_vector_db_tpu_torch.distributed.types import SessionToken

    svc = make_service(consistency=ConsistencyLevel.STRONG)
    try:
        leader = svc.leader_node().node_id
        follower = next(n for n in svc.nodes.values() if n.node_id != leader)
        session = SessionToken()
        docs = make_docs(12, seed=9)
        follower.upsert(docs, session=session)
        # every doc whose shard this follower owns is already in its store
        for d in docs:
            info = follower.shard_map.shards[follower.shard_map.shard_for_key(d.id)]
            if follower.node_id in info.all_nodes():
                assert follower.db.store.get(d.id) is not None, d.id
        # the token covers every affected shard with a version >= 1
        affected = {follower.shard_map.shard_for_key(d.id) for d in docs}
        assert set(session.versions) == affected
        assert all(v >= 1 for v in session.versions.values())
        # and a token-carrying search from the follower observes the write
        hits = follower.search(docs[3].vector, k=3, session=session)
        assert hits[0][0] == docs[3].id
    finally:
        svc.stop()


def test_search_surfaces_unsatisfiable_stale_shards():
    """ADVICE r1 (low): when a session demands versions no replica (nor the
    primary, after the retry) can satisfy, the search must report those
    shards stale instead of silently dropping the guarantee."""
    from grape_vector_db_tpu_torch.distributed.types import SessionToken

    svc = make_service()
    try:
        docs = make_docs(20, seed=5)
        svc.upsert(docs)
        node = svc.any_node()
        for n in svc.nodes.values():
            n.session_wait_s = 0.2
        session = SessionToken()
        # demand an impossible future version on shard 0
        session.observe(0, 10_000)
        stale: list = []
        hits = node.search(docs[2].vector, k=3, session=session, stale_out=stale)
        assert hits, "search must still return best-effort results"
        assert 0 in stale, f"unsatisfiable shard not surfaced: {stale}"
    finally:
        svc.stop()


def test_multi_raft_groups_strong_writes_scale():
    """Multi-raft (PARITY known gap): independent per-shard-group raft groups
    carry STRONG writes. Each group elects exactly one leader, writes land on
    exactly the owner nodes, session read-your-writes still holds, and
    concurrent batches across groups commit in parallel."""
    import threading

    from grape_vector_db_tpu_torch.distributed.types import SessionToken

    ccfg = ClusterConfig(
        shard_count=8, replica_count=2,
        consistency=ConsistencyLevel.STRONG,
        heartbeat_interval_s=0.2,
        election_timeout_ms=(80, 160), raft_heartbeat_ms=25.0,
        data_raft_groups=4,
    )
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 256
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0)
    svc = ClusterService([f"node-{i}" for i in range(3)], cluster_config=ccfg,
                         db_config=dcfg, raft_config=rcfg, device="cpu")
    svc.start()
    try:
        # every data group elects exactly one leader (generous deadline:
        # under full-suite load jit compiles starve the election timers)
        deadline = time.monotonic() + 20.0
        def leaders(g):
            return [nid for nid, n in svc.nodes.items()
                    if n.data_rafts[g].role.value == "leader"]
        while time.monotonic() < deadline:
            if all(len(leaders(g)) == 1 for g in range(4)):
                break
            time.sleep(0.05)
        per_group = {g: leaders(g) for g in range(4)}
        assert all(len(v) == 1 for v in per_group.values()), per_group

        # concurrent batches: each thread writes docs hashing to all groups
        node = svc.any_node()
        session = SessionToken()
        batches = [make_docs(25, seed=s, dim=16) for s in range(6)]
        for i, b in enumerate(batches):
            for d in b:
                d.id = f"b{i}-{d.id}"
        errs = []
        t0 = time.monotonic()

        def write(b):
            try:
                node.upsert(b, session=session)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=write, args=(b,)) for b in batches]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
        wall = time.monotonic() - t0
        assert not any(t.is_alive() for t in threads), "writer thread hung"
        assert not errs, errs
        assert wall < 30.0, f"concurrent multi-group writes too slow: {wall:.1f}s"

        # correctness: each doc lives exactly on its shard's owners. STRONG
        # guarantees majority commit + caller apply; follower appliers drain
        # the committed log asynchronously, so allow a bounded convergence
        # window before asserting.
        any_node = svc.any_node()
        for b in batches[:2]:
            for d in b[:5]:
                info = any_node.shard_map.shards[any_node.shard_map.shard_for_key(d.id)]
                deadline = time.monotonic() + 15.0
                while True:
                    holders = {nid for nid, n in svc.nodes.items()
                               if n.db.store.get(d.id) is not None}
                    if holders == set(info.all_nodes()) or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
                assert holders == set(info.all_nodes()), (d.id, holders)

        # read-your-writes across groups via the session token
        target = batches[0][3]
        hits = node.search(target.vector, k=3, session=session)
        assert hits[0][0] == target.id
    finally:
        svc.stop()


def test_empty_batches_are_noops():
    """Regression: STRONG upsert/delete with empty batches crashed unpacking
    an empty by_group dict."""
    svc = make_service(consistency=ConsistencyLevel.STRONG)
    try:
        assert svc.any_node().upsert([]) == 0
        assert svc.any_node().delete([]) == 0
    finally:
        svc.stop()


def test_snapshot_restore_resyncs_before_bumping_versions():
    """Regression: a data-group InstallSnapshot carries only version
    counters; restoring used to bump them without the documents, silently
    passing session read-your-writes on a node missing the writes. Now the
    node pulls its shards from a source whose OWN counter covers the target
    version before adopting it — and a target no source can vouch for is
    never adopted."""
    import msgpack as _mp

    svc = make_service(consistency=ConsistencyLevel.STRONG)
    try:
        docs = make_docs(30)
        svc.upsert(docs)
        # wait for cluster-wide apply so the resync sources are caught up
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            if sum(n.db.store.count() for n in svc.nodes.values()) == 60:
                break
            time.sleep(0.05)
        # pick a node and wipe some docs from its local store only (simulate
        # the compacted-log gap a snapshot-installed lagging node has).
        # Consider only docs of shards the victim OWNS — boot-churn absorbed
        # copies of other shards are transient (the relinquish sweep drops
        # them) and resync rightly does not restore them.
        victim = svc.any_node()
        with victim._state_lock:
            owned = victim._owned_shard_set()
        mine = [d.id for d in docs
                if victim.db.store.get(d.id) is not None
                and victim.shard_map.shard_for_key(d.id) in owned]
        assert mine, "victim holds no docs?"
        lost = mine[: max(1, len(mine) // 2)]
        victim.db.batch_delete_documents(lost)
        assert all(victim.db.store.get(i) is None for i in lost)

        # forge the snapshot blob a leader would send (current versions —
        # levels the live sources actually vouch for)
        with victim._version_lock:
            bump = dict(victim.shard_versions)
        blob = _mp.packb({"versions": {str(k): v for k, v in bump.items()}},
                         use_bin_type=True)
        victim._restore_versions(blob, group=-1)

        # the background resync must restore the wiped docs and settle
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            have = all(victim.db.store.get(i) is not None for i in lost)
            with victim._version_lock:
                settled = not victim._unready_shards
            if have and settled:
                break
            time.sleep(0.05)
        assert all(victim.db.store.get(i) is not None for i in lost), \
            "snapshot restore settled without pulling the documents"
        with victim._version_lock:
            assert not victim._unready_shards

        # honesty check: a forged target NO source has reached must never be
        # adopted — the shard stays unready (stale for session reads) instead
        # of silently vouching for writes this node does not hold
        sid = victim.shard_map.shard_for_key(lost[0])
        forged = bump.get(sid, 0) + 100
        blob2 = _mp.packb({"versions": {str(sid): forged}}, use_bin_type=True)
        victim._restore_versions(blob2, group=-1)
        time.sleep(1.0)
        with victim._version_lock:
            assert victim.shard_versions.get(sid, 0) < forged
            assert sid in victim._unready_shards
    finally:
        svc.stop()


def test_rest_cluster_delete_and_search_options():
    """Regression: REST DELETE in cluster mode was local-only (silent no-op
    when the doc lives on other owners); cluster search dropped
    score_threshold and with_payload."""
    import json
    import urllib.request

    from grape_vector_db_tpu_torch.server.rest import RestServer

    svc = make_service(consistency=ConsistencyLevel.SESSION)
    try:
        docs = make_docs(40)
        for d in docs:
            d.metadata = {"tag": d.id}
        svc.upsert(docs)
        # serve REST from a node that does NOT own doc-7's shard if possible
        sid = svc.any_node().shard_map.shard_for_key("doc-7")
        owners = set(svc.any_node().shard_map.shards[sid].all_nodes())
        host_id = next((n for n in svc.nodes if n not in owners),
                       next(iter(svc.nodes)))
        node = svc.nodes[host_id]
        srv = RestServer(node.db, port=0, node=node)
        addr = srv.start()
        base = f"http://{addr[0]}:{addr[1]}"
        try:
            # cluster search returns payloads and honors the threshold
            body = json.dumps({"vector": docs[7].vector, "limit": 5,
                               "score_threshold": 0.999,
                               "with_payload": True}).encode()
            req = urllib.request.Request(f"{base}/api/v1/search", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                out = json.loads(resp.read())
            assert out["results"], out
            assert all(r["score"] >= 0.999 for r in out["results"])
            top = out["results"][0]
            assert top["id"] == "doc-7" and top["payload"] == {"tag": "doc-7"}

            # DELETE routes through the cluster to the owners
            req = urllib.request.Request(f"{base}/api/v1/vectors/doc-7",
                                         method="DELETE")
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read())["deleted"] >= 1
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if all(n.db.store.get("doc-7") is None
                       for n in svc.nodes.values()):
                    break
                time.sleep(0.05)
            assert all(n.db.store.get("doc-7") is None
                       for n in svc.nodes.values())
        finally:
            srv.stop()
    finally:
        svc.stop()


def test_scatter_gather_scopes_hits_to_targeted_shards():
    """Regression: a node's local search covers its whole corpus (replica
    copies included), and the merge took every hit — a lagging replica's
    stale doc could ride into the results through a response that never
    reported its shard stale. Hits are now scoped to each node's targeted
    shards."""
    svc = make_service(consistency=ConsistencyLevel.SESSION)
    try:
        docs = make_docs(40)
        svc.upsert(docs)
        x = docs[7]
        node = svc.any_node()
        sid = node.shard_map.shard_for_key(x.id)
        info = node.shard_map.shards[sid]
        replicas = [n for n in info.replica_nodes if n != info.primary_node]
        assert replicas, "need a replica distinct from the primary"
        lagging = svc.nodes[replicas[0]]

        node.delete([x.id])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if all(n.db.store.get(x.id) is None for n in svc.nodes.values()):
                break
            time.sleep(0.05)
        # simulate a replica that lagged the delete: reintroduce X locally
        lagging.db.batch_add_documents([x])

        coordinator = svc.nodes[info.primary_node]
        hits = coordinator.search(x.vector, k=5)
        assert all(i != x.id for i, _ in hits), hits
    finally:
        svc.stop()


def test_get_documents_falls_through_to_live_replica():
    """Regression: payload materialization asked only the FIRST non-self
    owner per id; with that node down the payload silently dropped even
    though a replica held the document."""
    svc = make_service(consistency=ConsistencyLevel.SESSION)
    try:
        docs = make_docs(40)
        for d in docs:
            d.metadata = {"tag": d.id}
        svc.upsert(docs)
        x = docs[3]
        node = svc.any_node()
        sid = node.shard_map.shard_for_key(x.id)
        info = node.shard_map.shards[sid]
        owners = info.all_nodes()
        outsider_id = next(n for n in svc.nodes if n not in owners)
        outsider = svc.nodes[outsider_id]
        # take the preferred owner (primary) off the wire
        svc.transport.unregister(info.primary_node)
        try:
            got = outsider.get_documents([x.id])
            assert x.id in got and got[x.id].metadata == {"tag": x.id}, got
        finally:
            svc.transport.register(
                info.primary_node,
                svc.nodes[info.primary_node]._handle_rpc)
    finally:
        svc.stop()


def test_ownership_gain_triggers_data_resync():
    """Regression (multi-raft): placements commit through the main raft
    group while data commands flow through independent data groups, so a
    node can gain ownership of a shard AFTER having skipped its writes. The
    ownership-gain hook must resync the shard's documents from the existing
    owners."""
    svc = make_service(consistency=ConsistencyLevel.SESSION)
    try:
        docs = make_docs(40)
        svc.upsert(docs)
        x = docs[11]
        node = svc.any_node()
        sid = node.shard_map.shard_for_key(x.id)
        info = node.shard_map.shards[sid]
        owners = info.all_nodes()
        newcomer_id = next(n for n in svc.nodes if n not in owners)
        newcomer = svc.nodes[newcomer_id]
        assert newcomer.db.store.get(x.id) is None

        leader = next(n for n in svc.nodes.values()
                      if n.raft.role.name == "LEADER")
        leader._propose({
            "op": "set_placement", "shard_id": sid,
            "primary": info.primary_node,
            "replicas": list(info.replica_nodes) + [newcomer_id],
        }, wait_applied=True)

        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if newcomer.db.store.get(x.id) is not None:
                break
            time.sleep(0.05)
        assert newcomer.db.store.get(x.id) is not None, \
            "newly-owning node never pulled the shard's documents"
        # and the shard must leave the unready set once the data landed
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with newcomer._version_lock:
                if sid not in newcomer._unready_shards:
                    break
            time.sleep(0.05)
        with newcomer._version_lock:
            assert sid not in newcomer._unready_shards
    finally:
        svc.stop()


def test_runtime_node_addition_and_removal_full_stack():
    """Runtime membership (beyond the reference's fixed seed set): a brand
    new node splices into the RUNNING cluster — raft voter sets grow through
    the live leaders, shard placements re-spread onto it, the ownership-gain
    resync pulls its shards' data, and it serves coordinated reads/writes.
    Removal shrinks everything back."""
    ccfg = ClusterConfig(
        shard_count=8, replica_count=2,
        consistency=ConsistencyLevel.STRONG,
        heartbeat_interval_s=0.2, election_timeout_ms=(80, 160),
        raft_heartbeat_ms=25.0, data_raft_groups=2,
    )
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 256
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0,
                      tick_ms=5.0)
    svc = ClusterService([f"node-{i}" for i in range(3)], cluster_config=ccfg,
                         db_config=dcfg, raft_config=rcfg, device="cpu")
    svc.start()
    try:
        docs = make_docs(40)
        assert svc.any_node().upsert(docs) == 40

        newcomer = svc.add_node("node-3")
        # every raft group on every node adopts the new voter
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            ok = all(
                "node-3" in r.voters
                for n in svc.nodes.values()
                for r in [n.raft, *n.data_rafts.values()]
            )
            if ok:
                break
            time.sleep(0.05)
        assert ok, {nid: n.raft.voters for nid, n in svc.nodes.items()}

        # membership + placements reach the newcomer and include it
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with newcomer._state_lock:
                members_ok = len(newcomer.members) == 4
                owned = newcomer._owned_shard_set()
            if members_ok and owned:
                break
            time.sleep(0.05)
        assert members_ok and owned

        # ownership-gain resync must land the data of its shards (recompute
        # ownership each pass — placements can re-spread while we wait)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            with newcomer._state_lock:
                owned = newcomer._owned_shard_set()
            with newcomer._version_lock:
                settled = not newcomer._unready_shards
            have = bool(owned) and all(
                newcomer.db.store.get(d.id) is not None
                for d in docs
                if newcomer.shard_map.shard_for_key(d.id) in owned
            )
            if settled and have:
                break
            time.sleep(0.05)
        assert have, "newcomer never pulled its shards' documents"

        # the newcomer coordinates reads and STRONG writes
        hits = newcomer.search(docs[7].vector, k=3)
        assert hits and hits[0][0] == "doc-7"
        extra = make_docs(5, seed=99)
        for d in extra:
            d.id = f"late-{d.id}"
        assert newcomer.upsert(extra) == 5

        # removal shrinks the voter sets and placements back to survivors
        svc.remove_node("node-3")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            ok = all(
                "node-3" not in r.voters
                for n in svc.nodes.values()
                for r in [n.raft, *n.data_rafts.values()]
            ) and all(
                "node-3" not in i.all_nodes()
                for n in svc.nodes.values()
                for i in n.shard_map.shards.values()
            )
            if ok:
                break
            time.sleep(0.05)
        assert ok
        # the shrunk cluster still commits STRONG writes
        more = make_docs(3, seed=7)
        for d in more:
            d.id = f"post-{d.id}"
        assert svc.any_node().upsert(more) == 3
    finally:
        svc.stop()


def test_full_cluster_restart_resettles_completeness(tmp_path):
    """Regression: shard data-completeness flags were in-memory only, so a
    FULL cluster restart left zero complete holders anywhere and every
    resync deadlocked (shards unready forever, all session reads stale).
    Flags are now persisted and re-established on restart."""
    from grape_vector_db_tpu_torch.distributed.cluster import ClusterNode
    from grape_vector_db_tpu_torch.distributed.transport import (
        InProcessTransport,
        NetworkSimulator,
    )

    ids = [f"node-{i}" for i in range(3)]
    ccfg = ClusterConfig(
        shard_count=8, replica_count=2, consistency=ConsistencyLevel.STRONG,
        heartbeat_interval_s=0.2, election_timeout_ms=(80, 160),
        raft_heartbeat_ms=25.0,
    )
    dcfg = VectorDbConfig(vector_dimension=16)
    dcfg.device.storage_dtype = "float32"
    dcfg.index.initial_capacity = 256
    dcfg.cache.enabled = False
    rcfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0,
                      tick_ms=5.0)

    def boot(transport):
        nodes = {
            nid: ClusterNode(
                node_id=nid, address=f"inproc://{nid}", seed_nodes=ids,
                transport=transport, cluster_config=ccfg, db_config=dcfg,
                raft_config=rcfg, data_path=str(tmp_path / nid), device="cpu",
            )
            for nid in ids
        }
        for n in nodes.values():
            n.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if any(n.raft.leader_id for n in nodes.values()):
                break
            time.sleep(0.05)
        for n in nodes.values():
            n.join_cluster()
        return nodes

    transport = InProcessTransport(NetworkSimulator())
    nodes = boot(transport)
    try:
        docs = make_docs(30)
        assert nodes["node-0"].upsert(docs) == 30
        # wait until completeness settles everywhere (flags hit disk)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if all(
                not n._unready_shards and n._owned_shard_set() <= n._complete_shards
                for n in nodes.values()
            ):
                break
            time.sleep(0.05)
    finally:
        for n in nodes.values():
            n.stop()

    # FULL restart from the persisted stores
    transport2 = InProcessTransport(NetworkSimulator())
    nodes = boot(transport2)
    try:
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            with_unready = [nid for nid, n in nodes.items()
                            if n._unready_shards]
            if not with_unready:
                break
            time.sleep(0.05)
        assert not with_unready, (
            f"resync deadlocked after full restart: {with_unready}"
        )
        hits = nodes["node-1"].search(docs[7].vector, k=3)
        assert hits and hits[0][0] == "doc-7", hits
    finally:
        for n in nodes.values():
            n.stop()


def test_membership_change_survives_node_failure_mid_join():
    """Chaos: a node FAILS while a newcomer is being spliced in. The
    membership machinery must either finish the splice (quorum holds: 3->4
    voters needs 3) or leave a retryable state — never a wedged cluster."""
    svc = make_service(consistency=ConsistencyLevel.SESSION)
    try:
        docs = make_docs(30)
        svc.upsert(docs)
        victim = next(nid for nid in svc.nodes
                      if nid != svc.leader_node().node_id)
        # fail a non-leader node, then immediately add a newcomer while the
        # failure detector / failover is still reacting
        svc.sim.fail_node(victim)
        newcomer = svc.add_node("node-3", timeout_s=20.0)

        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            live = [n for nid, n in svc.nodes.items() if nid != victim]
            if all("node-3" in n.raft.voters for n in live):
                break
            time.sleep(0.05)
        live = [n for nid, n in svc.nodes.items() if nid != victim]
        assert all("node-3" in n.raft.voters for n in live)

        # the 3 live voters (of 4) still commit writes and serve reads
        extra = make_docs(5, seed=42)
        for d in extra:
            d.id = f"x-{d.id}"
        assert newcomer.upsert(extra) == 5
        hits = newcomer.search(extra[2].vector, k=3)
        assert hits and hits[0][0] == extra[2].id
    finally:
        svc.stop()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_membership_churn_converges(seed):
    """Randomized churn: interleaved node adds, removals, failures,
    recoveries, and writes. Invariants at the end: a single live leader,
    all live nodes agree on the voter set, and fresh writes are served."""
    rng = np.random.default_rng(seed)
    svc = make_service(consistency=ConsistencyLevel.SESSION)
    next_id = 3
    live_failed: set = set()
    try:
        svc.upsert(make_docs(20))
        for step in range(6):
            op = rng.choice(["add", "remove", "fail", "recover", "write"])
            names = list(svc.nodes)
            try:
                if op == "add" and len(svc.nodes) < 6:
                    svc.add_node(f"node-{next_id}", timeout_s=15.0)
                    next_id += 1
                elif op == "remove" and len(svc.nodes) - len(live_failed) > 3:
                    victim = rng.choice([n for n in names
                                         if n not in live_failed])
                    svc.remove_node(str(victim), timeout_s=15.0)
                elif op == "fail" and len(svc.nodes) - len(live_failed) > 3:
                    victim = str(rng.choice([n for n in names
                                             if n not in live_failed]))
                    svc.sim.fail_node(victim)
                    live_failed.add(victim)
                elif op == "recover" and live_failed:
                    victim = live_failed.pop()
                    svc.sim.recover_node(victim)
                elif op == "write":
                    batch = make_docs(5, seed=100 + step)
                    for d in batch:
                        d.id = f"s{step}-{d.id}"
                    svc.any_node().upsert(batch)
            except Exception:
                pass  # individual op may time out under churn; convergence
                      # is what the end-state asserts
            time.sleep(0.2)

        # heal everything and let the cluster settle
        for v in list(live_failed):
            svc.sim.recover_node(v)
        live = {nid: n for nid, n in svc.nodes.items()}
        deadline = time.monotonic() + 20.0
        ok = False
        while time.monotonic() < deadline:
            voters = {tuple(sorted(n.raft.voters)) for n in live.values()}
            leaders = [n.node_id for n in live.values()
                       if n.raft.role.name == "LEADER"]
            if len(voters) == 1 and len(leaders) == 1:
                ok = True
                break
            time.sleep(0.1)
        assert ok, (voters, leaders)

        # the settled cluster accepts and serves a fresh write
        final = make_docs(3, seed=999)
        for d in final:
            d.id = f"final-{d.id}"
        assert svc.any_node().upsert(final) == 3
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            hits = svc.any_node().search(final[1].vector, k=3)
            if hits and hits[0][0] == final[1].id:
                break
            time.sleep(0.1)
        assert hits and hits[0][0] == final[1].id
    finally:
        svc.stop()


def test_data_reconcile_upserts_only_newer(svc):
    """The relinquish handoff's anti-entropy RPC: a doc lands only when
    locally absent or strictly newer by updated_at — a deposed owner's
    stale revision never clobbers a current owner's later update, while
    writes only the old owner still holds are preserved (the chaos-suite
    data-loss mode: drop-on-trusted-complete erased acknowledged docs)."""
    node = svc.any_node()
    base = make_docs(1, seed=5)[0]
    base.id = "recon-doc"
    base.content = "current revision"
    base.updated_at = 2000
    node.db.batch_add_documents([base])

    stale = Document(id="recon-doc", content="stale revision",
                     vector=base.vector, updated_at=1000)
    missing = Document(id="recon-missing", content="only on old owner",
                       vector=base.vector, updated_at=1500)
    newer = Document(id="recon-doc2", content="newer revision",
                     vector=base.vector, updated_at=3000)
    node.db.batch_add_documents([Document(
        id="recon-doc2", content="old revision", vector=base.vector,
        updated_at=2500)])

    resp = node._handle_rpc("data_reconcile", {
        "docs": [d.to_dict() for d in (stale, missing, newer)]})
    assert resp["accepted"] == 2  # missing + newer; stale rejected

    assert node.db.store.get("recon-doc").content == "current revision"
    assert node.db.store.get("recon-missing").content == "only on old owner"
    assert node.db.store.get("recon-doc2").content == "newer revision"


def test_relinquish_hands_off_before_dropping(svc):
    """Deterministic reconstruction of the chaos-suite data-loss mode: a
    deposed owner holds acknowledged docs the current owners miss (their
    complete flags went stale through a resync chain while the true holder
    was down). The relinquish sweep must push the docs to every current
    owner before dropping its local copy — never trust the flag alone."""
    docs = make_docs(6, seed=11)
    svc.any_node().upsert(docs)
    # pick a doc and find a node that physically holds it
    target = docs[0]
    holder = next(n for n in svc.nodes.values()
                  if n.db.store.get(target.id) is not None)
    sid = holder._shard_of_record(target.id)
    others = [n for n in svc.nodes.values() if n.node_id != holder.node_id]

    # simulate the stale-complete divergence: current owners lose the doc
    # but still claim the shard complete; the holder is deposed from the
    # placement yet keeps its (true) complete flag
    for n in others:
        if n.db.store.get(target.id) is not None:
            n.db.batch_delete_documents([target.id])
        with n._version_lock:
            n._complete_shards.add(sid)
            n._persist_complete()
    for n in svc.nodes.values():
        with n._state_lock:
            info = n.shard_map.shards[sid]
            info.primary_node = others[0].node_id
            info.replica_nodes = [others[1].node_id]
    with holder._version_lock:
        holder._complete_shards.add(sid)
        holder._persist_complete()

    holder._relinquish_complete()

    # the doc must have been handed to BOTH current owners, and the
    # holder's copy dropped along with its complete flag
    for n in others:
        rec = n.db.store.get(target.id)
        assert rec is not None and rec.content == target.content
    assert holder.db.store.get(target.id) is None
    with holder._version_lock:
        assert sid not in holder._complete_shards


def test_concurrent_scatter_search_under_load(svc):
    """Many client threads scatter-searching at once: the per-node search
    batcher must pack them without deadlock, timeout, or misrouting
    (regression for the batched _rpc_data_search path)."""
    import concurrent.futures

    docs = make_docs(120)
    svc.upsert(docs)
    nodes = list(svc.nodes.values())
    vecs = {int(d.id.split("-")[1]): np.asarray(d.vector, np.float32)
            for d in docs}

    def one(i):
        nd = nodes[i % len(nodes)]
        qi = i % 120
        hits = nd.search(vecs[qi], k=3)
        assert hits, f"empty hits for {qi}"
        assert hits[0][0] == f"doc-{qi}", (qi, hits[:2])
        return True

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        assert all(ex.map(one, range(160)))
    assert time.monotonic() - t0 < 60, "scatter search under load too slow"
    # the batcher actually packed: fewer launches than queries on some node
    assert any(n._search_batcher.batches_run < n._search_batcher.queries_run
               for n in nodes)


def test_search_batch_api_matches_single_query_scatter(svc):
    """ClusterNode.search_batch: Q queries in ONE RPC per target node must
    return, per query, the same ranking the single-query scatter does."""
    docs = make_docs(60)
    svc.upsert(docs)
    node = svc.any_node()
    picks = [3, 11, 42, 57]
    res = node.search_batch([docs[i].vector for i in picks], k=5)
    assert len(res) == len(picks)
    for hits, i in zip(res, picks):
        assert hits[0][0] == f"doc-{i}"
        single = node.search(docs[i].vector, k=5)
        assert [h[0] for h in hits] == [h[0] for h in single]
    assert node.search_batch([], k=5) == []


def test_coordinator_leg_batcher_packs_concurrent_searches(svc):
    """Session-less concurrent searches through one coordinator must pack
    into data_search_batch legs: strictly fewer RPCs than legs on the wire
    (the coordinator-side half of the serving-tier batching story)."""
    import concurrent.futures

    docs = make_docs(80)
    svc.upsert(docs)
    node = svc.any_node()
    # widen the pack window so packing is deterministic under CI load (the
    # leg batchers are created lazily on first use, reading this config).
    # coordinator_batch defaults OFF since the measured A/B (per-node
    # batching already packs legs; bench/cluster_qps.py) — opt in here to
    # exercise the packer path itself.
    node.db.config.device.coordinator_batch = True
    node.db.config.device.micro_batch_wait_ms = 50.0

    def one(i):
        hits = node.search(docs[i].vector, k=3)
        assert hits[0][0] == f"doc-{i}", (i, hits[:2])
        return True

    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        assert all(ex.map(one, range(64)))
    stats = [(lb.rpcs_sent, lb.legs_packed)
             for lb in node._leg_batchers.values()]
    assert stats, "coordinator leg batchers never engaged"
    assert sum(l for _, l in stats) > sum(r for r, _ in stats), stats


def test_session_searches_bypass_the_leg_batcher(svc):
    """A session-carrying search has per-shard version gates and per-query
    stale/retry semantics — it must take the direct data_search path, not
    the packed one."""
    from grape_vector_db_tpu_torch.distributed.types import SessionToken

    docs = make_docs(30)
    node = svc.any_node()
    session = SessionToken()
    node.upsert(docs, session=session)
    assert session.versions
    hits = node.search(docs[9].vector, k=3, session=session)
    assert hits[0][0] == "doc-9"
    assert not node._leg_batchers, "session search rode the leg batcher"


def test_cluster_health_stays_healthy_past_the_stale_window(svc):
    """A node never receives its own heartbeat RPC, so the service's
    staleness sweep must touch each node's own LB entry — otherwise every
    node goes stale-SUSPECTED once uptime passes stale_after_s and health
    reports a permanently degraded cluster (regression: exposed by a
    slow-relay tpu_cluster_smoke; searches were fine, health stuck at 2/3)."""
    import time as _time

    for n in svc.nodes.values():
        n.load_balancer.config.stale_after_s = 0.05
    _time.sleep(max(0.4, svc.config.heartbeat_interval_s * 4))
    h = svc.any_node().cluster_health()
    assert h.status == "healthy" and h.healthy_nodes == 3, (
        h.status, h.healthy_nodes)
    # and the LB did not quietly suspect peers it IS hearing from
    for n in svc.nodes.values():
        assert n.load_balancer.route_request()


def test_failed_scatter_leg_retries_at_replica(svc):
    """A scatter leg that dies in flight (transport drop / stalled handler
    past its budget) must not silently lose its shards from the top-k: the
    coordinator retries each shard once at its next healthy owner (RF=2
    keeps one). Regression for the relay-stall mode where one leg timed out
    and self-match quietly dropped to 2/8."""
    from grape_vector_db_tpu_torch.distributed.transport import TransportError

    docs = make_docs(60)
    svc.upsert(docs)
    coord = svc.nodes["node-0"]
    victim = "node-1"
    orig = svc.transport._handlers[victim]
    state = {"dropped": 0}

    def flaky(method, payload):
        if method == "data_search" and state["dropped"] == 0:
            state["dropped"] += 1
            raise TransportError("injected: leg lost in flight")
        return orig(method, payload)

    svc.transport._handlers[victim] = flaky
    try:
        # a doc whose shard's primary is the victim, so its leg is the one
        # that drops
        sid_of = coord.shard_map.shard_for_key
        target = next(
            d for d in docs
            if coord.shard_map.shards[sid_of(d.id)].primary_node == victim)
        stale: list = []
        hits = coord.search(target.vector, k=3, stale_out=stale)
        assert state["dropped"] == 1, "injected leg failure never fired"
        assert hits and hits[0][0] == target.id, (hits[:3], stale)
    finally:
        svc.transport._handlers[victim] = orig


# -- tests/test_distributed.py's scenarios ----------------------------------------------------

# -- consistent hash ring -------------------------------------------------------


def test_ring_distribution_and_stability():
    ring = ConsistentHashRing(virtual_nodes=100)
    for n in ("a", "b", "c"):
        ring.add_node(n)
    keys = [f"key-{i}" for i in range(3000)]
    owners = {k: ring.node_for(k) for k in keys}
    counts = {n: sum(1 for o in owners.values() if o == n) for n in ("a", "b", "c")}
    assert all(c > 500 for c in counts.values()), counts  # roughly balanced
    # removing one node only remaps its keys
    ring.remove_node("c")
    moved = sum(1 for k in keys if owners[k] != "c" and ring.node_for(k) != owners[k])
    assert moved == 0


def test_shard_map_ranges_and_routing():
    m = ShardMap(shard_count=16, replica_count=3)
    m.assign_all(["n0", "n1", "n2", "n3"])
    # every shard has 1 primary + 2 replicas, all distinct
    for info in m.shards.values():
        nodes = info.all_nodes()
        assert len(nodes) == 3 and len(set(nodes)) == 3
    # routing is deterministic and in range
    sid = m.shard_for_key("doc-123")
    assert 0 <= sid < 16
    assert m.shard_for_key("doc-123") == sid
    info = m.nodes_for_key("doc-123")
    assert info.shard_id == sid


def test_shard_map_promote_replica():
    m = ShardMap(shard_count=4, replica_count=2)
    m.assign_all(["a", "b", "c"])
    sid = next(s for s, i in m.shards.items() if i.primary_node == "a")
    old = m.shards[sid].replica_nodes[0]
    new_primary = m.promote_replica(sid, "a")
    assert new_primary == old
    assert m.shards[sid].primary_node == old


# -- migration over an in-memory data access ---------------------------------------


class DictDataAccess(ShardDataAccess):
    def __init__(self, shard_map):
        self.map = shard_map
        self.nodes = {}

    def ensure(self, nid):
        return self.nodes.setdefault(nid, {})

    def count_shard(self, nid, sid):
        return sum(1 for d in self.ensure(nid).values()
                   if self.map.shard_for_key(d["id"]) == sid)

    def pull_shard(self, nid, sid):
        return [d for d in self.ensure(nid).values()
                if self.map.shard_for_key(d["id"]) == sid]

    def push_docs(self, nid, docs):
        store = self.ensure(nid)
        for d in docs:
            store[d["id"]] = d
        return len(docs)

    def drop_shard(self, nid, sid):
        store = self.ensure(nid)
        ids = [k for k in store if self.map.shard_for_key(k) == sid]
        for k in ids:
            del store[k]
        return len(ids)


def test_shard_migration_pipeline():
    m = ShardMap(shard_count=4, replica_count=1)
    m.assign_all(["a", "b"])
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    # load docs onto their primaries
    for i in range(200):
        d = {"id": f"doc-{i}", "updated_at": i}
        info = m.nodes_for_key(d["id"])
        data.push_docs(info.primary_node, [d])
    sid = next(s for s, i in m.shards.items() if i.primary_node == "a")
    before = data.count_shard("a", sid)
    assert before > 0
    report = mgr.migrate_shard(sid, "b")
    assert report.verified and report.docs_moved == before
    assert m.shards[sid].primary_node == "b"
    assert data.count_shard("a", sid) == 0
    assert data.count_shard("b", sid) == before


def test_rebalance_plan_equalizes():
    m = ShardMap(shard_count=8, replica_count=1)
    m.assign_all(["a"])  # all 8 shards on a
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    moves = mgr.plan_rebalance(["a", "b"])
    assert len(moves) >= 3
    assert all(dst == "b" for _, dst in moves)
    mgr.rebalance(["a", "b"])
    assert 3 <= len(m.shards_on_node("b", primary_only=True)) <= 5


# -- replication -------------------------------------------------------------------


def make_repl(policy, fail_nodes=()):
    written = {}

    def write(nid, docs):
        if nid in fail_nodes:
            raise ConnectionError(f"{nid} down")
        written.setdefault(nid, []).extend(docs)
        return len(docs)

    return ReplicationManager(write, policy=policy, replica_timeout_s=0.5), written


def test_replication_synchronous_all_acks():
    mgr, written = make_repl(SyncPolicy.SYNCHRONOUS)
    r = mgr.replicate([{"id": "x"}], "p", ["r1", "r2"])
    assert r.acks == 3
    assert set(written) == {"p", "r1", "r2"}
    mgr.close()


def test_replication_sync_fails_on_dead_replica():
    mgr, _ = make_repl(SyncPolicy.SYNCHRONOUS, fail_nodes={"r2"})
    with pytest.raises(ReplicationError):
        mgr.replicate([{"id": "x"}], "p", ["r1", "r2"])
    mgr.close()


def test_replication_quorum_tolerates_one_dead():
    mgr, written = make_repl(SyncPolicy.QUORUM, fail_nodes={"r2"})
    r = mgr.replicate([{"id": "x"}], "p", ["r1", "r2"])
    assert r.acks == 2  # p + r1 = majority of 3
    mgr.close()


def test_replication_async_returns_immediately():
    mgr, written = make_repl(SyncPolicy.ASYNCHRONOUS)
    r = mgr.replicate([{"id": "x"}], "p", ["r1"])
    assert r.acks == 1 and r.pending_async == 1
    time.sleep(0.2)
    assert "r1" in written
    health = mgr.replica_health()
    assert health["p"].confirm_rate == 1.0
    mgr.close()


def test_replication_primary_failure_raises():
    mgr, _ = make_repl(SyncPolicy.QUORUM, fail_nodes={"p"})
    with pytest.raises(ReplicationError, match="primary"):
        mgr.replicate([{"id": "x"}], "p", ["r1"])
    mgr.close()


# -- failure detector ----------------------------------------------------------------


def test_failure_detector_thresholds():
    up = {"n1": True}
    events = []
    det = FailureDetector(lambda n: up[n], fail_after=3, recover_after=2,
                          on_state_change=lambda n, s: events.append((n, s.value)))
    det.watch("n1")
    det.probe_all()
    assert det.state_of("n1") == NodeState.HEALTHY
    up["n1"] = False
    det.probe_all()
    assert det.state_of("n1") == NodeState.SUSPECTED
    det.probe_all(); det.probe_all()
    assert det.state_of("n1") == NodeState.FAILED
    up["n1"] = True
    det.probe_all()
    assert det.state_of("n1") == NodeState.RECOVERING
    det.probe_all()
    assert det.state_of("n1") == NodeState.HEALTHY
    kinds = [s for _, s in events]
    assert kinds == ["suspected", "failed", "recovering", "healthy"]


def test_failover_promotes_and_replaces():
    m = ShardMap(shard_count=4, replica_count=2)
    m.assign_all(["a", "b", "c"])
    data = DictDataAccess(m)
    for i in range(100):
        d = {"id": f"doc-{i}", "updated_at": i}
        info = m.nodes_for_key(d["id"])
        for nid in info.all_nodes():
            data.push_docs(nid, [d])
    mgr = ShardManager(m, data)
    fo = FailoverManager(mgr, healthy_nodes_fn=lambda: ["b", "c"], replica_count=2)
    fo.enqueue_failure("a")
    tasks = fo.run_pending()
    assert tasks and all(t.done for t in tasks)
    # no shard has 'a' anywhere anymore
    for info in m.shards.values():
        assert "a" not in info.all_nodes()
        assert info.primary_node in ("b", "c")
    kinds = {t.kind for t in tasks}
    assert RecoveryKind.PRIMARY_FAILOVER in kinds


# -- load balancer -----------------------------------------------------------------


def lb_with_nodes(strategy, n=4):
    lb = IntelligentLoadBalancer(LoadBalancerConfig(strategy=strategy))
    for i in range(n):
        lb.add_node(NodeInfo(node_id=f"n{i}", address=f"h{i}:1"))
    return lb


def test_lb_round_robin_exact_split():
    lb = lb_with_nodes("round_robin", n=2)
    picks = [lb.route_request()[0] for _ in range(10)]
    assert picks.count("n0") == 5 and picks.count("n1") == 5  # load_balancer.rs:587-665


def test_lb_least_connections():
    lb = lb_with_nodes("least_connections", n=3)
    lb.on_request_start("n0"); lb.on_request_start("n0"); lb.on_request_start("n1")
    assert lb.route_request()[0] == "n2"


def test_lb_skips_failed_nodes_and_weight_update():
    lb = lb_with_nodes("load_based", n=3)
    lb.set_node_state("n0", NodeState.FAILED)
    picks = {lb.route_request()[0] for _ in range(10)}
    assert "n0" not in picks
    for _ in range(20):  # EMA converges toward 2000ms -> weight ~ 1000/2100
        lb.on_request_start("n1")
        lb.on_request_end("n1", response_ms=2000.0, success=True)
    stats = lb.stats()
    assert stats["n1"]["weight"] < 0.6
    assert stats["n1"]["weight"] >= 0.1  # clamp floor


def test_lb_no_healthy_nodes():
    lb = lb_with_nodes("round_robin", n=1)
    lb.set_node_state("n0", NodeState.FAILED)
    with pytest.raises(UnavailableError):
        lb.route_request()


def test_lb_balance_report():
    lb = lb_with_nodes("round_robin", n=2)
    for _ in range(20):
        nid = lb.route_request()[0]
        lb.on_request_start(nid)
        lb.on_request_end(nid, 10.0, True)
    rep = lb.balance_report()
    assert rep.balanced and rep.max_deviation < 0.15


# -- request router ---------------------------------------------------------------


def test_router_failover_to_backup():
    lb = lb_with_nodes("round_robin", n=3)
    calls = []

    def send(node_id, request):
        calls.append(node_id)
        if node_id == calls[0]:  # first target always fails
            raise ConnectionError("down")
        return f"ok-from-{node_id}"

    router = ClusterAwareRequestRouter(lb, send)
    out = router.execute({"q": 1})
    assert out.startswith("ok-from-")
    m = router.get_metrics()
    assert m.success == 1 and m.failovers == 1


def test_router_cache_and_all_fail():
    lb = lb_with_nodes("round_robin", n=2)
    count = {"n": 0}

    def send(node_id, request):
        count["n"] += 1
        return count["n"]

    router = ClusterAwareRequestRouter(lb, send)
    a = router.execute("req", cache_key="k1")
    b = router.execute("req", cache_key="k1")
    assert a == b and count["n"] == 1
    assert router.get_metrics().cache_hits == 1

    def always_fail(node_id, request):
        raise ConnectionError("nope")

    router2 = ClusterAwareRequestRouter(lb, always_fail)
    with pytest.raises(UnavailableError):
        router2.execute("req")
    assert router2.get_metrics().failed == 1


def test_apply_placement_for_failure_deterministic_and_targeted():
    """ADVICE r1 (medium): placement repair must be a pure function of
    replicated state (safe on every raft applier) and hand back targeted
    resync tasks for the leader's background worker — no RPCs inline."""
    m = ShardMap(shard_count=4, replica_count=2)
    m.assign_all(["a", "b", "c"])
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    fo = FailoverManager(mgr, healthy_nodes_fn=lambda: ["b", "c"], replica_count=2)

    m2 = ShardMap(shard_count=4, replica_count=2)
    m2.assign_all(["a", "b", "c"])

    tasks = fo.apply_placement_for_failure("a", healthy=["b", "c"])
    # no shard references the failed node anywhere
    for info in m.shards.values():
        assert "a" not in info.all_nodes()
        assert info.primary_node in ("b", "c")
        # regression: shards where "a" was PRIMARY must be topped back up
        # too (promotion removes "a" from the shard, so a post-promotion
        # shards_on_node pass used to skip them -> permanent
        # under-replication)
        assert len(set(info.all_nodes())) == 2, info
    # resync tasks target exactly the freshly added replicas
    for t in tasks:
        assert t.kind == RecoveryKind.DATA_RESYNC and t.targets
        info = m.shards[t.shard_id]
        for tgt in t.targets:
            assert tgt in info.all_nodes()
    # determinism: a second applier with identical replicated state converges
    # on the identical map
    mgr2 = ShardManager(m2, DictDataAccess(m2))
    fo2 = FailoverManager(mgr2, healthy_nodes_fn=lambda: ["b", "c"], replica_count=2)
    fo2.apply_placement_for_failure("a", healthy=["b", "c"])
    for sid in m.shards:
        assert m.shards[sid].primary_node == m2.shards[sid].primary_node
        assert m.shards[sid].replica_nodes == m2.shards[sid].replica_nodes


def test_failed_primary_only_shard_elects_new_primary_and_recovers():
    """Regression: a shard whose dead primary had no replicas kept the dead
    node as primary (promote_replica returns None), so the queued resync
    pulled from the dead node on every recovery cycle and writes kept
    routing at it. Now a healthy node becomes the (empty) new primary and
    recovery pulls skip the dead source."""
    m = ShardMap(shard_count=4, replica_count=1)
    m.assign_all(["a", "b", "c"])  # replica_count=1 -> primary-only shards
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    fo = FailoverManager(mgr, healthy_nodes_fn=lambda: ["b", "c"],
                         replica_count=1)

    tasks = fo.apply_placement_for_failure("a", healthy=["b", "c"])
    for info in m.shards.values():
        assert info.primary_node in ("b", "c"), info
        assert "a" not in info.all_nodes()
    # the recovery tasks must complete without error against the new owners
    fo.enqueue_tasks(tasks)
    done = fo.run_pending()
    assert all(not (t.result or "").startswith("error:") for t in done), \
        [t.result for t in done]


def test_lb_staleness_never_corrupts_the_shared_membership_view():
    """sweep_stale's SUSPECTED is an LB-local routing hint. When the caller
    registers the raft-replicated membership NodeInfo, the sweep must not
    mutate it (regression: the shared object let every node's OWN entry go
    stale-SUSPECTED after stale_after_s — a node never heartbeats itself —
    and cluster_health reported a permanently degraded cluster once uptime
    crossed 60 s; exposed by a slow-relay tpu_cluster_smoke run)."""
    from grape_vector_db_tpu_torch.distributed.types import NodeInfo, NodeState

    lb = IntelligentLoadBalancer(LoadBalancerConfig(stale_after_s=0.01))
    member = NodeInfo(node_id="n0", address="x")
    lb.add_node(member)
    time.sleep(0.05)
    assert lb.sweep_stale() == ["n0"]
    # LB view suspected, membership view untouched
    assert member.state == NodeState.HEALTHY
    # explicit membership transitions still reach the LB
    lb.set_node_state("n0", NodeState.FAILED)
    assert member.state == NodeState.HEALTHY


# -- the port against the JAX package: one deployment, the same documents ------------------

PAR_N, PAR_D = 4096, 64


def _par_service(pkg, shard_count=8):
    """A 3-node, 8-shard, RF=2 cluster of ``pkg`` (the port on the CPU) with
    the default flat, cosine, bf16 index at D = 64."""
    ccfg = pkg["ClusterConfig"](shard_count=shard_count, replica_count=2,
                                consistency=pkg["ConsistencyLevel"].SESSION,
                                heartbeat_interval_s=0.2, election_timeout_ms=(80, 160),
                                raft_heartbeat_ms=25.0)
    dcfg = pkg["VectorDbConfig"](vector_dimension=PAR_D)
    dcfg.index.initial_capacity = 1024
    dcfg.cache.enabled = False
    rcfg = pkg["RaftConfig"](election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0)
    extra = {"device": "cpu"} if pkg["name"] == "torch" else {}
    svc = pkg["ClusterService"]([f"node-{i}" for i in (1, 2, 3)], cluster_config=ccfg,
                                db_config=dcfg, raft_config=rcfg, **extra)
    svc.start()
    return svc


def _pkg(name):
    if name == "torch":
        return {"name": name, "ClusterService": ClusterService, "ClusterConfig": ClusterConfig,
                "ConsistencyLevel": ConsistencyLevel, "VectorDbConfig": VectorDbConfig,
                "RaftConfig": RaftConfig, "Document": Document, "SessionToken": SessionToken}
    from grape_vector_db_tpu.config import VectorDbConfig as JConfig
    from grape_vector_db_tpu.distributed.cluster_service import ClusterService as JService
    from grape_vector_db_tpu.distributed.raft import RaftConfig as JRaft
    from grape_vector_db_tpu.distributed.types import (ClusterConfig as JCluster,
                                                       ConsistencyLevel as JLevel,
                                                       SessionToken as JToken)
    from grape_vector_db_tpu.types import Document as JDocument

    return {"name": name, "ClusterService": JService, "ClusterConfig": JCluster,
            "ConsistencyLevel": JLevel, "VectorDbConfig": JConfig, "RaftConfig": JRaft,
            "Document": JDocument, "SessionToken": JToken}


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 rows rounded to bf16 (to nearest even), as the index stores them."""
    b = x.astype(np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.view(np.float32)


def _oracle(x: np.ndarray, ids, q: np.ndarray, k: int):
    """Exact cosine top-k over the stored (bf16) rows of ``ids``."""
    rows = _bf16(x[ids])
    rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = qn @ rows.T
    top = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return [[(f"p{ids[j]}", float(s[r, j])) for j in row] for r, row in enumerate(top)]


def _wait(cond, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not reached within {timeout_s} s")


@pytest.fixture(scope="module")
def par_data():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((PAR_N, PAR_D)).astype(np.float32)
    q = np.concatenate([x[:6] + 0.05 * rng.standard_normal((6, PAR_D)),
                        rng.standard_normal((6, PAR_D))]).astype(np.float32)
    return x, q


def _drive(name, x, q):
    """One sequence of operations on ``name``'s cluster; every answer is held
    to the oracle and returned for the cross-package comparison."""
    pkg = _pkg(name)
    svc = _par_service(pkg)
    out = {}
    try:
        tok = pkg["SessionToken"]()
        for i in range(0, PAR_N, 1024):
            svc.upsert([pkg["Document"](id=f"p{j}", content=f"row {j}", vector=x[j].tolist())
                        for j in range(i, i + 1024)], session=tok)
        node = svc.any_node()
        out["shards"] = [node.shard_map.shard_for_key(f"p{j}") for j in range(PAR_N)]
        out["placements"] = {sid: (i.primary_node, list(i.replica_nodes))
                             for sid, i in node.shard_map.snapshot().items()}
        out["stored"] = {nid: sorted(n.db.store.iter_ids()) for nid, n in svc.nodes.items()}
        live = np.arange(PAR_N)
        for k in (10, 3):
            got = [svc.search(v, k=k, session=tok) for v in q.tolist()]
            assert_hits_match(got, _oracle(x, live, q, k), 3e-3)
            out[f"search{k}"] = got
        got = svc.search_batch(q.tolist(), k=10, session=tok)
        assert_hits_match(got, _oracle(x, live, q, 10), 3e-3)
        out["batch"] = got

        # delete: the ids never come back, with or without the session
        gone = [f"p{j}" for j in range(0, 12)]
        assert svc.delete(gone, session=tok) == len(gone)
        live = np.arange(12, PAR_N)
        got = [svc.search(v, k=10, session=tok) for v in q.tolist()]
        assert not {i for row in got for i, _ in row} & set(gone)
        assert_hits_match(got, _oracle(x, live, q, 10), 3e-3)
        out["deleted"] = got

        # failover: node-3 fails, every shard keeps an owner at RF=2
        svc.sim.fail_node("node-3")
        n1 = svc.nodes["node-1"]
        _wait(lambda: n1.cluster_health().status != "healthy", 15.0, "failure detection")
        got = [n1.search(v, k=10) for v in q.tolist()]
        assert_hits_match(got, _oracle(x, live, q, 10), 3e-3)
        out["failed"] = got
        svc.sim.recover_node("node-3")
        _wait(lambda: n1.cluster_health().status == "healthy", 15.0, "recovery")

        # partition and heal: the majority side keeps answering exactly
        svc.sim.create_partition({"node-1", "node-2"}, {"node-3"})
        got = [n1.search(v, k=10) for v in q.tolist()]
        assert_hits_match(got, _oracle(x, live, q, 10), 3e-3)
        svc.sim.heal_partition()

        # runtime membership: a fourth node joins, takes shards, leaves
        n4 = svc.add_node("node-4", timeout_s=15.0)
        _wait(lambda: all(len(n.members) == 4 for n in svc.nodes.values()), 15.0, "join")
        _wait(lambda: n4.db.store.count() > 0, 15.0, "the joiner's resync")
        svc.remove_node("node-4", timeout_s=15.0)
        _wait(lambda: all("node-4" not in n.healthy_node_ids() for n in svc.nodes.values()),
              15.0, "leave")
        # the survivors regain the leaver's shards and resync them: session-
        # less answers are whole again once that has settled
        want = _oracle(x, live, q, 10)
        deadline = time.monotonic() + 15.0
        while True:
            got = [n1.search(v, k=10) for v in q.tolist()]
            try:
                assert_hits_match(got, want, 3e-3)
                break
            except AssertionError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        out["after_churn"] = got
    finally:
        svc.stop()
    return out


@pytest.fixture(scope="module")
def par_runs(par_data):
    x, q = par_data
    return {name: _drive(name, x, q) for name in ("torch", "jax")}


def test_cluster_placements_match_jax(par_runs):
    a, b = par_runs["torch"], par_runs["jax"]
    assert a["shards"] == b["shards"]
    assert a["placements"] == b["placements"]
    assert a["stored"] == b["stored"]
    # RF=2: every document on exactly two of the three nodes
    counts = {}
    for ids in a["stored"].values():
        for i in ids:
            counts[i] = counts.get(i, 0) + 1
    assert len(counts) == PAR_N and set(counts.values()) == {2}


@pytest.mark.parametrize("key", ["search10", "search3", "batch", "deleted", "failed",
                                 "after_churn"])
def test_cluster_answers_match_jax(par_runs, key):
    assert_hits_match(par_runs["torch"][key], par_runs["jax"][key], 3e-3)

"""The scenarios of tests/test_raft.py on the PyTorch port's Raft and its
``RaftTestCluster``, then the raft log and snapshot of one package's
``RaftNode`` read back by the other's.

Raft consensus tests — the intent of the reference's disabled
raft_comprehensive_tests (single-leader election on 3/6-node clusters, log
replication, partition handling; raft_comprehensive_tests.rs.disabled:1-70) —
but actually running, against a real implementation."""

import time

import numpy as np
import pytest

from grape_vector_db_tpu_torch.distributed.raft import RaftConfig, RaftRole
from grape_vector_db_tpu_torch.errors import NotLeaderError
from grape_vector_db_tpu_torch.testing import RaftTestCluster

FAST = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0)


@pytest.fixture()
def cluster3():
    c = RaftTestCluster(3, config=FAST)
    c.start()
    yield c
    c.stop()


def test_single_leader_election_3(cluster3):
    leader = cluster3.wait_for_leader()
    time.sleep(0.3)
    assert cluster3.leaders() == [leader]
    # every node agrees on the leader
    for n in cluster3.nodes.values():
        assert n.leader_id == leader


def test_single_leader_election_6():
    c = RaftTestCluster(6, config=FAST)
    c.start()
    try:
        leader = c.wait_for_leader()
        time.sleep(0.3)
        assert c.leaders() == [leader]
    finally:
        c.stop()


def test_log_replication_to_all(cluster3):
    leader = cluster3.wait_for_leader()
    node = cluster3.nodes[leader]
    for i in range(5):
        idx = node.propose(f"cmd-{i}".encode())
        assert idx == i + 1
    cluster3.wait_applied(5)
    cluster3.verify_log_consistency()
    assert cluster3.applied[leader] == [f"cmd-{i}".encode() for i in range(5)]


def test_propose_on_follower_raises_or_forwards(cluster3):
    leader = cluster3.wait_for_leader()
    follower = next(n for n in cluster3.node_ids if n != leader)
    with pytest.raises(NotLeaderError):
        cluster3.nodes[follower].propose(b"x")
    # forwarding path
    idx = cluster3.nodes[follower].propose_on_leader(b"fwd")
    assert idx >= 1
    cluster3.wait_applied(1)


def test_partition_elects_new_leader_and_heals(cluster3):
    leader = cluster3.wait_for_leader()
    others = {n for n in cluster3.node_ids if n != leader}
    # commit something first
    cluster3.nodes[leader].propose(b"before")
    cluster3.wait_applied(1)

    # isolate the leader; the majority side elects a new one
    cluster3.partition({leader}, others)
    new_leader = cluster3.wait_for_leader(among=others, timeout_s=5.0)
    assert new_leader != leader

    # majority side can still commit
    idx = cluster3.nodes[new_leader].propose(b"during")
    assert idx == 2
    cluster3.wait_applied(2, among=others)

    # old leader cannot commit
    with pytest.raises(Exception):
        cluster3.nodes[leader].propose(b"stale", timeout_s=0.3)

    # heal: old leader steps down and converges
    cluster3.heal()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if cluster3.nodes[leader].role == RaftRole.FOLLOWER:
            break
        time.sleep(0.02)
    assert cluster3.nodes[leader].role == RaftRole.FOLLOWER
    cluster3.wait_applied(2)
    cluster3.verify_log_consistency()


def test_no_commit_without_majority(cluster3):
    leader = cluster3.wait_for_leader()
    # partition every node from every other: no quorum anywhere
    cluster3.partition(*({n} for n in cluster3.node_ids))
    with pytest.raises(Exception):
        cluster3.nodes[leader].propose(b"nope", timeout_s=0.4)
    cluster3.heal()


def test_crash_restart_recovers_from_storage():
    c = RaftTestCluster(3, config=FAST)
    c.start()
    try:
        leader = c.wait_for_leader()
        for i in range(4):
            c.nodes[leader].propose(f"v{i}".encode())
        c.wait_applied(4)
        victim = next(n for n in c.node_ids if n != leader)
        c.kill_node(victim)
        c.nodes[leader].propose(b"while-down")
        # restart from persisted state; it must catch up
        c.applied[victim] = []  # state machine resets on crash; log replays
        c.restart_node(victim)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if len(c.applied[victim]) >= 5:
                break
            time.sleep(0.02)
        assert len(c.applied[victim]) >= 5
        c.verify_log_consistency()
    finally:
        c.stop()


def test_snapshot_compaction_and_catchup():
    cfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0, tick_ms=5.0,
                     snapshot_threshold=20)
    c = RaftTestCluster(3, config=cfg, snapshots=True)
    c.start()
    try:
        leader = c.wait_for_leader()
        lagger = next(n for n in c.node_ids if n != leader)
        c.sim.fail_node(lagger)
        for i in range(40):
            c.nodes[leader].propose(f"s{i}".encode())
        others = {n for n in c.node_ids if n != lagger}
        c.wait_applied(40, among=others)
        time.sleep(0.3)  # allow compaction
        assert c.nodes[leader].snapshot_last_index > 0
        assert len(c.nodes[leader].log) < 40
        # recover the lagger: it must catch up via InstallSnapshot
        c.sim.recover_node(lagger)
        deadline = time.monotonic() + 6.0
        while time.monotonic() < deadline:
            if len(c.applied[lagger]) >= 40:
                break
            time.sleep(0.05)
        assert len(c.applied[lagger]) >= 40, (
            f"lagger only applied {len(c.applied[lagger])}"
        )
        c.verify_log_consistency()
    finally:
        c.stop()


def test_leader_stability_under_packet_loss(cluster3):
    leader = cluster3.wait_for_leader()
    cluster3.sim.set_packet_loss(leader, 0.2)
    for i in range(10):
        try:
            cluster3.nodes[cluster3.wait_for_leader()].propose(
                f"lossy-{i}".encode(), timeout_s=2.0
            )
        except Exception:
            pass  # occasional timeout under loss is fine
    cluster3.sim.set_packet_loss(leader, 0.0)
    time.sleep(0.5)
    cluster3.verify_log_consistency()


def test_prevote_prevents_term_inflation(cluster3):
    """Raft thesis §9.6: a node isolated through many election timeouts must
    NOT inflate its term (pre-vote fails without a majority), and on heal it
    must rejoin as follower without deposing the healthy leader."""
    leader = cluster3.wait_for_leader()
    cluster3.nodes[leader].propose(b"stable")
    cluster3.wait_applied(1)
    term_before = cluster3.nodes[leader].current_term

    victim = next(n for n in cluster3.node_ids if n != leader)
    others = {n for n in cluster3.node_ids if n != victim}
    cluster3.partition({victim}, others)
    # several election timeouts elapse while isolated
    time.sleep(1.0)
    assert cluster3.nodes[victim].current_term == term_before, (
        "isolated node inflated its term despite pre-vote"
    )

    cluster3.heal()
    time.sleep(0.5)
    # the healthy leader was never deposed and the term did not jump
    assert cluster3.nodes[leader].role == RaftRole.LEADER
    assert cluster3.nodes[leader].current_term == term_before
    assert cluster3.nodes[victim].role == RaftRole.FOLLOWER
    assert cluster3.nodes[victim].leader_id == leader


def test_election_without_prevote_still_works():
    """prevote=False keeps the classic immediate-candidate behavior."""
    cfg = RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0,
                     tick_ms=5.0, prevote=False)
    c = RaftTestCluster(3, config=cfg)
    c.start()
    try:
        leader = c.wait_for_leader()
        c.nodes[leader].propose(b"x")
        c.wait_applied(1)
    finally:
        c.stop()


def test_match_index_excludes_stale_uncommitted_tail():
    """Raft safety regression (ADVICE r1, high): a follower whose log carries
    a stale uncommitted tail from an earlier term passes the prev check on an
    empty heartbeat — it must report match_index = prev_log_index +
    len(entries), NOT its own last_log_index, or the leader counts it toward
    commit majorities for entries it does not hold."""
    from grape_vector_db_tpu_torch.distributed.raft import LogEntry, RaftNode
    from grape_vector_db_tpu_torch.distributed.transport import InProcessTransport

    applied = []
    tp = InProcessTransport()
    node = RaftNode("f1", ["f1", "l1"], tp, apply_fn=lambda e: applied.append(e))
    # term-1 log: entry 1 was committed; 2-3 are a stale uncommitted tail the
    # new term-2 leader (which only has entry 1) never saw.
    node.current_term = 1
    node.log = [
        LogEntry(index=1, term=1, entry_type="command", data=b"a"),
        LogEntry(index=2, term=1, entry_type="command", data=b"lost-b"),
        LogEntry(index=3, term=1, entry_type="command", data=b"lost-c"),
    ]
    resp = node.handle_append_entries({
        "term": 2, "leader_id": "l1",
        "prev_log_index": 1, "prev_log_term": 1,
        "entries": [], "leader_commit": 3,
    })
    assert resp["success"] is True
    assert resp["match_index"] == 1, resp
    # commit_index must also stop at the verified prefix: the leader's 2-3
    # differ from this follower's stale 2-3.
    assert node.commit_index == 1


def test_propose_success_when_entry_compacted_during_wait():
    """ADVICE r1 (low): if snapshot compaction advances past the proposed
    index while propose() waits, the entry committed+applied — that's
    success, not 'overwritten by a new leader'."""
    c = RaftTestCluster(3, config=FAST)
    c.start()
    try:
        leader = c.wait_for_leader()
        node = c.nodes[leader]
        idx = node.propose(b"x", wait_applied=True)
        node.propose(b"y", wait_applied=True)
        # simulate compaction having advanced PAST idx (covers idx and later)
        with node._lock:
            node.snapshot_last_index = idx + 1
            node.snapshot_last_term = node.current_term
            node.log = [e for e in node.log if e.index > idx + 1]
        # the old index's term is gone from the log and the snapshot boundary
        assert node._term_at(idx) is None
        # wait_applied_through on a compacted index returns immediately
        node.wait_applied_through(idx, timeout_s=0.5)
    finally:
        c.stop()


# -- runtime membership changes (raft thesis ch. 4, single-server) ----------------


def test_add_voter_joins_and_participates(cluster3):
    leader = cluster3.wait_for_leader()
    node = cluster3.nodes[leader]
    for i in range(4):
        node.propose(f"pre-{i}".encode())
    cluster3.wait_applied(4)

    cluster3.add_node("node-3")
    node.add_voter("node-3")
    # the config replicates everywhere, including the new node
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if all("node-3" in n.voters for n in cluster3.nodes.values()):
            break
        time.sleep(0.02)
    assert all("node-3" in n.voters for n in cluster3.nodes.values())

    # the new node backfills the pre-join log and applies post-join entries
    node.propose(b"post-0")
    cluster3.wait_applied(5)
    assert cluster3.applied["node-3"][:4] == [f"pre-{i}".encode()
                                              for i in range(4)]

    # 4 voters: majority is 3 — losing one node must still commit
    victim = next(n for n in cluster3.node_ids
                  if n not in (leader, "node-3"))
    cluster3.kill_node(victim)
    leader2 = cluster3.wait_for_leader(
        among=set(cluster3.node_ids) - {victim})
    idx = cluster3.nodes[leader2].propose(b"post-1", timeout_s=5.0)
    assert idx >= 6


def test_remove_voter_shrinks_majority_and_quiesces(cluster3):
    leader = cluster3.wait_for_leader()
    node = cluster3.nodes[leader]
    removed = next(n for n in cluster3.node_ids if n != leader)
    node.remove_voter(removed)

    survivors = set(cluster3.node_ids) - {removed}
    for nid in survivors:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if removed not in cluster3.nodes[nid].voters:
                break
            time.sleep(0.02)
        assert removed not in cluster3.nodes[nid].voters

    # the removed node learns of its removal (courtesy appends) and stops
    # standing for election
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if removed not in cluster3.nodes[removed].voters:
            break
        time.sleep(0.02)
    assert removed not in cluster3.nodes[removed].voters

    # 2 voters: both required for commit — still works, and BOTH survivors
    # apply it
    node.propose(b"after-removal", timeout_s=5.0)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if all(b"after-removal" in cluster3.applied[nid] for nid in survivors):
            break
        time.sleep(0.02)
    assert all(b"after-removal" in cluster3.applied[nid] for nid in survivors)
    # the removed node must not disrupt: terms stay put while the leader lives
    term_before = node.current_term
    time.sleep(1.0)
    assert node.current_term == term_before
    assert node.role.value == "leader"


def test_removed_leader_steps_down(cluster3):
    leader = cluster3.wait_for_leader()
    node = cluster3.nodes[leader]
    node.remove_voter(leader)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if node.role.value != "leader":
            break
        time.sleep(0.02)
    assert node.role.value != "leader"
    # the remaining two voters elect a new leader and keep committing
    new_leader = cluster3.wait_for_leader(
        among=set(cluster3.node_ids) - {leader})
    cluster3.nodes[new_leader].propose(b"life-goes-on", timeout_s=5.0)


def test_membership_changes_one_server_at_a_time(cluster3):
    from grape_vector_db_tpu_torch.errors import ConsensusError

    leader = cluster3.wait_for_leader()
    node = cluster3.nodes[leader]
    others = [n for n in cluster3.node_ids if n != leader]
    with pytest.raises(ConsensusError):
        node.change_membership([leader])  # drops two voters at once


def test_membership_forwarding_from_follower(cluster3):
    leader = cluster3.wait_for_leader()
    follower = next(n for n in cluster3.node_ids if n != leader)
    cluster3.add_node("node-3")
    voters = sorted(set(cluster3.nodes[leader].voters) | {"node-3"})
    idx = cluster3.nodes[follower].membership_on_leader(voters)
    assert idx >= 1
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if "node-3" in cluster3.nodes[leader].voters:
            break
        time.sleep(0.02)
    assert "node-3" in cluster3.nodes[leader].voters


def test_removed_node_quiesces_after_leader_crash():
    """Regression: courtesy appends informing a removed node live only on
    the removing leader. If that leader dies before the removed node hears,
    the node campaigns forever on its stale config — a majority of probed
    peers now answers 'you are removed' and the node suppresses elections."""
    c = RaftTestCluster(5, config=FAST)
    c.start()
    try:
        leader = c.wait_for_leader()
        node = c.nodes[leader]
        removed = next(n for n in c.node_ids if n != leader)
        # cut the victim off BEFORE the removal commits, so it never
        # receives the config entry removing it
        c.sim.fail_node(removed)
        node.remove_voter(removed, timeout_s=5.0)
        # the removing leader crashes — its courtesy-append bookkeeping dies
        # with it (4 voters remain, 3 alive: quorum holds)
        c.kill_node(leader)
        survivors = set(c.node_ids) - {leader, removed}
        new_leader = c.wait_for_leader(among=survivors, timeout_s=10.0)
        # heal the victim: it still believes it is a voter of the old config
        c.sim.recover_node(removed)
        victim = c.nodes[removed]
        assert removed in victim.voters  # stale self-view
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            if victim._suppress_elections:
                break
            time.sleep(0.02)
        assert victim._suppress_elections, \
            "removed node never learned of its removal via prevote probes"
        # and the live cluster's term stays stable under its probes
        term = c.nodes[new_leader].current_term
        time.sleep(1.0)
        assert c.nodes[new_leader].current_term == term
        assert c.nodes[new_leader].role.value == "leader"
    finally:
        c.stop()


# -- one store, both packages: the raft log and snapshot cross ---------------------------


def _package(name):
    if name == "torch":
        from grape_vector_db_tpu_torch.distributed import raft
        from grape_vector_db_tpu_torch.distributed.transport import InProcessTransport
        from grape_vector_db_tpu_torch.storage.store import MemoryDocumentStore
        from grape_vector_db_tpu_torch import testing
    else:
        from grape_vector_db_tpu.distributed import raft
        from grape_vector_db_tpu.distributed.transport import InProcessTransport
        from grape_vector_db_tpu.storage.store import MemoryDocumentStore
        from grape_vector_db_tpu import testing
    return raft, InProcessTransport, MemoryDocumentStore, testing


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_raft_store_crosses_packages(writer, reader):
    """A raft log (data and config entries) and a compacted snapshot written
    by ``writer``'s RaftNode into its store: ``reader``'s RaftNode restarts
    on a copy of that store with the same term, vote, voters, snapshot point,
    log and state machine, and writes the same bytes back."""
    import msgpack

    w_raft, _, _, w_testing = _package(writer)
    r_raft, r_transport, r_store, _ = _package(reader)
    cfg = w_raft.RaftConfig(election_timeout_ms=(80, 160), heartbeat_ms=25.0,
                            tick_ms=5.0, snapshot_threshold=20)
    c = w_testing.RaftTestCluster(3, config=cfg, snapshots=True)
    c.start()
    try:
        leader = c.wait_for_leader()
        rng = np.random.default_rng(3)
        cmds = [msgpack.packb({"op": "data_upsert", "docs": [
            {"id": f"d{i}", "vector": rng.standard_normal(24).tolist()}]}) for i in range(30)]
        for cmd in cmds:
            c.nodes[leader].propose(cmd)
        c.nodes[leader].membership_on_leader(sorted(c.node_ids), timeout_s=5.0)
        c.wait_applied(30)
        deadline = time.monotonic() + 5.0
        while c.nodes[leader].snapshot_last_index == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        src = c.nodes[leader]
        assert src.snapshot_last_index > 0 and src.log, "no compaction and tail to cross"
    finally:
        c.stop()
    kv = dict(c.storages[leader].iter_kv_prefix(""))
    assert any(k.startswith("raft_snapshot_") for k in kv)
    store = r_store()
    for k, v in kv.items():
        store.put_kv(k, v)
    # the reader's state machine decodes the snapshot with its own codec
    codec = r_raft.msgpack
    restored = []
    node = r_raft.RaftNode(
        leader, list(c.node_ids), r_transport(), lambda e: None, storage=store,
        config=r_raft.RaftConfig(**vars(cfg)),
        snapshot_fn=lambda: codec.packb(restored),
        restore_fn=lambda blob: restored.extend(codec.unpackb(blob, raw=False)))
    assert (node.current_term, node.voted_for) == (src.current_term, src.voted_for)
    assert (node.snapshot_last_index, node.snapshot_last_term) == (
        src.snapshot_last_index, src.snapshot_last_term)
    assert node.voters == src.voters
    assert [e.to_wire() for e in node.log] == [e.to_wire() for e in src.log]
    snap = next(v for k, v in kv.items() if k.startswith("raft_snapshot_"))
    assert restored and restored == msgpack.unpackb(snap, raw=False)
    assert restored == c.applied[leader][:len(restored)]
    # the reader persists the same state and entries byte for byte
    node._persist_state()
    node._persist_entries(node.log)
    assert dict(store.iter_kv_prefix("")) == kv

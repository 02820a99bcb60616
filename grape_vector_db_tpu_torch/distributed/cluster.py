"""ClusterNode — one member of a sharded, replicated, Raft-coordinated cluster.

Folds the reference's ClusterManager (cluster.rs:97-823) and the data-plane
glue the reference mocked. Architecture:

- metadata plane: membership + shard placement changes are Raft-proposed
  commands (msgpack) applied deterministically on every node; the shard map is
  a pure function of the applied command sequence (cluster.rs join/leave +
  shard re-primary semantics).
- data plane: documents route by hash-range shard to the shard's primary and
  replicas; the coordinating node writes copies under the configured
  SyncPolicy (replication.rs semantics). Searches scatter to one owner per
  shard, merge by score, dedupe by doc id (shard.rs:759-901 for real).
- failure handling: every node heartbeats its peers through the transport; the
  FailureDetector's FAILED transitions become Raft-proposed ``node_failed``
  commands so the whole cluster agrees on membership state, then failover
  tasks re-primary shards and top up replicas (failover.rs intent).

Raft membership is static per cluster boot (the node set is the configured
seed list — the reference likewise fixes peers via config, raft.rs:1470-1478);
join/leave commands toggle liveness inside that set.
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from grape_vector_db_tpu_torch.storage import msgpack_codec as msgpack
import numpy as np
import torch

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.db import VectorDatabase
from grape_vector_db_tpu_torch.distributed.failover import FailoverManager, FailureDetector
from grape_vector_db_tpu_torch.distributed.load_balancer import IntelligentLoadBalancer
from grape_vector_db_tpu_torch.distributed.raft import LogEntry, RaftConfig, RaftNode
from grape_vector_db_tpu_torch.distributed.replication import ReplicationManager, SyncPolicy
from grape_vector_db_tpu_torch.distributed.shard import (
    ShardDataAccess,
    ShardManager,
    ShardMap,
)
from grape_vector_db_tpu_torch.distributed.transport import Transport, TransportError
from grape_vector_db_tpu_torch.distributed.types import (
    ClusterConfig,
    ClusterHealth,
    ConsistencyLevel,
    NodeInfo,
    NodeState,
    SessionToken,
)
from grape_vector_db_tpu_torch.errors import (
    ConsensusError,
    NotLeaderError,
    ReplicationError,
    UnavailableError,
)
from grape_vector_db_tpu_torch.types import Document, DocumentRecord

__all__ = ["ClusterNode"]

logger = logging.getLogger("grape_vector_db_tpu_torch.cluster")


class _GroupTransport(Transport):
    """Transport facade binding a data raft group: outgoing raft RPCs carry a
    ``_group`` tag the receiving ClusterNode uses to route to the right
    RaftNode. The node's transport slot stays owned by ClusterNode, so
    register/unregister are no-ops here."""

    def __init__(self, inner: Transport, group: int):
        self.inner = inner
        self.group = group

    def register(self, node_id: str, handler) -> None:  # slot owned by node
        pass

    def unregister(self, node_id: str) -> None:
        pass

    def call(self, src: str, dst: str, method: str, payload: Dict[str, Any],
             timeout_s: float = 1.0) -> Dict[str, Any]:
        return self.inner.call(src, dst, method,
                               {**payload, "_group": self.group},
                               timeout_s=timeout_s)


class _TransportDataAccess(ShardDataAccess):
    """ShardDataAccess over the node-to-node transport."""

    def __init__(self, node: "ClusterNode"):
        self.node = node

    def count_shard(self, node_id: str, shard_id: int) -> int:
        resp = self.node._call(node_id, "data_count", {"shard_id": shard_id})
        return resp["count"]

    def pull_shard(self, node_id: str, shard_id: int) -> List[Dict[str, Any]]:
        resp = self.node._call(node_id, "data_pull", {"shard_id": shard_id},
                               timeout_s=10.0)
        return resp["docs"]

    def push_docs(self, node_id: str, docs: List[Dict[str, Any]]) -> int:
        resp = self.node._call(node_id, "data_write", {"docs": docs}, timeout_s=10.0)
        return resp["written"]

    def drop_shard(self, node_id: str, shard_id: int) -> int:
        resp = self.node._call(node_id, "data_drop", {"shard_id": shard_id},
                               timeout_s=10.0)
        return resp["dropped"]


class _SearchLegBatcher:
    """Coordinator-side leg packer: concurrent session-less scatter legs
    headed to ONE node ride a single ``data_search_batch`` RPC.

    Under concurrent client load scatter-gather cost is leg-count-bound:
    every search issues one transport round trip per target node, and on
    TPU serving tiers each landing leg costs a device-launch slot
    (~25 ms RT through the dev relay). The per-node device micro-batcher
    (ClusterNode._search_batcher) already packs LAUNCHES on the serving
    side; this packs the WIRE — N concurrent searches targeting the same
    node become one RPC carrying N vectors, so the per-window leg count
    drops N-fold and the receiving node's batcher sees the whole pack at
    once (fuller launches, no per-query wait-window accrual).
    Session-carrying legs bypass this path: their per-shard version gates
    and stale/retry semantics are per-query (shard.rs:759-901's fan-out,
    batched the TPU way)."""

    def __init__(self, call_fn, max_batch: int = 64,
                 max_wait_ms: float = 2.0):
        import queue

        self._call = call_fn  # payload -> resp dict (raises TransportError)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[Optional[Tuple[Any, int, Any]]]" = queue.Queue()
        self._queue_mod = queue
        self._stop = False
        self.rpcs_sent = 0
        self.legs_packed = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gvdb-leg-batcher")
        self._thread.start()

    def submit(self, vector: List[float], k: int
               ) -> "concurrent.futures.Future[Dict[str, Any]]":
        fut: "concurrent.futures.Future[Dict[str, Any]]" = (
            concurrent.futures.Future())
        self._q.put((vector, k, fut))
        return fut

    def _collect(self):
        try:
            first = self._q.get(timeout=0.1)
        except self._queue_mod.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except self._queue_mod.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while not self._stop:
            batch = self._collect()
            if not batch:
                continue
            by_k: Dict[int, List[Tuple[Any, int, Any]]] = {}
            for item in batch:
                by_k.setdefault(item[1], []).append(item)
            for k, group in by_k.items():
                try:
                    resp = self._call({"vectors": [g[0] for g in group],
                                       "k": k})
                    per_q = resp["hits_per_query"]
                    stale = resp.get("stale", [])
                    self.rpcs_sent += 1
                    self.legs_packed += len(group)
                    for (_, _, fut), hits in zip(group, per_q):
                        fut.set_result({"hits": hits, "stale": stale})
                except Exception as e:
                    for _, _, fut in group:
                        if not fut.done():
                            fut.set_exception(e)

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=2.0)


class ClusterNode:
    def __init__(
        self,
        node_id: str,
        address: str,
        seed_nodes: Sequence[str],
        transport: Transport,
        cluster_config: Optional[ClusterConfig] = None,
        db_config: Optional[VectorDbConfig] = None,
        raft_config: Optional[RaftConfig] = None,
        data_path: Optional[str] = None,
        auto_shard: bool = True,
        device: str | torch.device = "cuda",
    ):
        # ``device`` holds this node's index: the card unless the caller
        # asks for the CPU
        self.node_id = node_id
        self.address = address
        self.config = cluster_config or ClusterConfig()
        self.transport = transport
        # Two-level scatter-gather (shard.rs:759-901, TPU-composed): DCN
        # fan-out between cluster nodes (below), ICI shard_map within the
        # node — a host with >1 local device serves one mesh-sharded index.
        # Deep-copy before mutating: the caller may share one config object
        # across nodes or standalone databases.
        import copy

        db_config = copy.deepcopy(db_config) if db_config else VectorDbConfig()
        if auto_shard:
            db_config.device.auto_shard = True
        self.db = VectorDatabase(path=data_path, config=db_config, device=device)

        # Per-node micro-batcher for shard-local searches: every transport
        # (in-process AND gRPC Internal) routes scatter-gather legs through
        # _rpc_data_search, so concurrent coordinator fan-ins from many
        # client threads pack into shared device launches here instead of
        # serializing one ~25 ms dispatch per query per shard (measured:
        # 39 -> 1000+ QPS under 64-thread load, bench/cluster_qps.py). Same
        # executor the gRPC front door uses (grpc_server.py:95-103).
        from grape_vector_db_tpu_torch.services.concurrent import BatchingExecutor

        # no padding to one batch size (pad_to=None): eager PyTorch compiles
        # no shapes, and the segment kernels take any batch up to their cap
        self._search_batcher = BatchingExecutor(
            self.db.engine.vector_search_batch,
            max_batch=self.db.config.device.max_query_batch,
            max_wait_ms=self.db.config.device.micro_batch_wait_ms,
        )

        # Coordinator-side leg packers (lazy, one per target node): pack
        # concurrent session-less scatter legs into data_search_batch RPCs.
        self._leg_batchers: Dict[str, _SearchLegBatcher] = {}
        self._leg_batchers_lock = threading.Lock()

        # replicated cluster state (derived from applied raft commands)
        self._state_lock = threading.RLock()
        self.members: Dict[str, NodeInfo] = {}
        self.shard_map = ShardMap(
            shard_count=self.config.shard_count,
            replica_count=self.config.replica_count,
        )
        self._applied_commands = 0

        # Per-shard applied-write versions backing SESSION read-your-writes
        # tokens: bumped on every locally applied write, compared (and briefly
        # waited on) by token-carrying searches. Initialized BEFORE the
        # RaftNode constructions below — their restore_fn fires during
        # construction (persisted-snapshot restore) and touches this state.
        self._version_lock = threading.Lock()
        self._version_cv = threading.Condition(self._version_lock)
        self.shard_versions: Dict[int, int] = {}
        self.session_wait_s = 1.0
        # Shards this node owns whose local data may be incomplete: gained
        # ownership (placement change / snapshot-installed counters) without
        # having applied the shard's writes. Session reads report them stale
        # until the background resync pulls the data from another owner.
        # Guarded by _version_lock (read on the data_search path).
        self._unready_shards: Set[int] = set()
        # Shards whose data this node provably holds IN FULL (absorbed every
        # committed write while complete, or resynced from a complete
        # source). Version counters are a pure function of the group log and
        # bump on EVERY node, so they can never identify data holders —
        # completeness is the signal resync sources are chosen by. A node
        # that loses ownership KEEPS absorbing a complete shard's writes
        # until the new owners finish their resyncs (anti-entropy
        # relinquish), so at least one complete source always exists.
        # Guarded by _version_lock. PERSISTED (store KV): a restarted node
        # re-establishes its flags and replays the raft log back to
        # completeness — without persistence a full-cluster restart would
        # leave zero complete holders and deadlock every resync. A
        # compacted-log gap (InstallSnapshot) demotes the flag
        # (_restore_versions): replay can no longer prove completeness.
        self._complete_shards: Set[int] = set()
        raw = self.db.store.get_kv(f"gvdb_complete_{node_id}")
        if raw:
            self._complete_shards = set(msgpack.unpackb(raw, raw=False))
        # sid -> version counter to adopt once the shard's data landed
        # (0 = just pull; counters already advanced through the group log).
        self._resync_lock = threading.Lock()
        self._resync_targets: Dict[int, int] = {}
        self._resync_wake = threading.Event()
        self._relinquish_tick = 0
        self._recovery_wake = threading.Event()
        self._started = False

        self.data_access = _TransportDataAccess(self)
        self.shard_manager = ShardManager(self.shard_map, self.data_access,
                                          rebalance_threshold=self.config.rebalance_threshold)
        self.replication = ReplicationManager(
            write_fn=self._replica_write,
            policy={"strong": SyncPolicy.SYNCHRONOUS,
                    "eventual": SyncPolicy.ASYNCHRONOUS,
                    "session": SyncPolicy.QUORUM}.get(
                        self.config.consistency.value, SyncPolicy.QUORUM),
        )
        self.load_balancer = IntelligentLoadBalancer()
        self.detector = FailureDetector(
            probe_fn=self._probe_peer,
            interval_s=self.config.heartbeat_interval_s,
            on_state_change=self._on_peer_state_change,
        )
        self.failover = FailoverManager(
            self.shard_manager, self.healthy_node_ids,
            replica_count=self.config.replica_count,
        )

        self.raft = RaftNode(
            node_id, list(seed_nodes), transport,
            apply_fn=self._apply_command,
            storage=self.db.store,
            config=raft_config or RaftConfig(
                election_timeout_ms=self.config.election_timeout_ms,
                heartbeat_ms=self.config.raft_heartbeat_ms,
            ),
            # Snapshot the replicated control state so the log compacts —
            # without this, STRONG-mode data commands (full vectors) accumulate
            # in the log forever. Document data itself is durable in each
            # node's own store; replayed data commands are idempotent.
            snapshot_fn=self._snapshot_state,
            restore_fn=self._restore_state,
        )
        # Multi-raft (PARITY known-gap closed): independent data raft groups
        # carry STRONG data commands; the main group keeps metadata. Shard ->
        # group by shard_id % n. Each group persists under its own namespace.
        # Data-group snapshots carry only the group's shard version counters;
        # a log-compacted lagging node pulls the missing documents itself on
        # InstallSnapshot (_restore_versions -> _resync_then_bump) and bumps
        # each counter only after that shard's data landed.
        self.data_rafts: Dict[int, RaftNode] = {}
        for g in range(self.config.data_raft_groups):
            self.data_rafts[g] = RaftNode(
                node_id, list(seed_nodes), _GroupTransport(transport, g),
                apply_fn=self._apply_command,
                storage=self.db.store,
                config=raft_config or RaftConfig(
                    election_timeout_ms=self.config.election_timeout_ms,
                    heartbeat_ms=self.config.raft_heartbeat_ms,
                ),
                persist_ns=f"{node_id}@g{g}",
                snapshot_fn=self._snapshot_versions,
                restore_fn=(lambda blob, g=g: self._restore_versions(blob,
                                                                     group=g)),
            )

        # Take over the transport slot: route raft methods to the raft node and
        # data/cluster methods to this object.
        transport.register(node_id, self._handle_rpc)
        self._raft_methods = {"request_prevote", "request_vote", "append_entries",
                              "install_snapshot", "client_command",
                              "change_membership"}

    # ------------------------------------------------------------------ rpc

    def _handle_rpc(self, method: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        if method in self._raft_methods:
            group = payload.pop("_group", None)
            raft = self.raft if group is None else self.data_rafts[group]
            return raft._handle_rpc(method, payload)
        handler = getattr(self, f"_rpc_{method}", None)
        if handler is None:
            raise UnavailableError(f"unknown method {method}")
        return handler(payload)

    def _call(self, dst: str, method: str, payload: Dict[str, Any],
              timeout_s: float = 2.0) -> Dict[str, Any]:
        if dst == self.node_id:
            return self._handle_rpc(method, payload)
        return self.transport.call(self.node_id, dst, method, payload,
                                   timeout_s=timeout_s)

    # -------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.raft.start()
        for r in self.data_rafts.values():
            r.start()
        self.detector.start()
        self._stop_reconcile = threading.Event()
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True,
            name=f"gvdb-reconcile-{self.node_id}",
        )
        self._reconcile_thread.start()
        self._recovery_thread = threading.Thread(
            target=self._recovery_loop, daemon=True,
            name=f"gvdb-recovery-{self.node_id}",
        )
        self._recovery_thread.start()
        self._resync_thread = threading.Thread(
            target=self._resync_loop, daemon=True,
            name=f"gvdb-resync-{self.node_id}",
        )
        self._resync_thread.start()
        self._started = True

    def stop(self) -> None:
        self._started = False
        self._stop_reconcile.set()
        self._recovery_wake.set()
        self._resync_wake.set()
        self._reconcile_thread.join(timeout=2.0)
        self._recovery_thread.join(timeout=2.0)
        self._resync_thread.join(timeout=2.0)
        self.detector.stop()
        self.raft.stop()
        for r in self.data_rafts.values():
            r.stop()
        self.replication.close()
        if "_mraft_pool" in self.__dict__:  # cached_property: only if created
            self._mraft_pool.shutdown(wait=False)
        self._search_batcher.close()
        with self._leg_batchers_lock:
            for lb in self._leg_batchers.values():
                lb.close()
            self._leg_batchers.clear()
        self.db.close()
        self.transport.unregister(self.node_id)

    def _reconcile_loop(self) -> None:
        """Leader-side anti-entropy: detector transitions propose state changes
        one-shot, and a proposal can land during leader churn (e.g. a rejoining
        node's inflated term forces re-election) and be lost. The leader
        periodically re-compares its local detector view against the replicated
        member states and re-proposes any disagreement."""
        from grape_vector_db_tpu_torch.distributed.raft import RaftRole

        while not self._stop_reconcile.wait(self.config.heartbeat_interval_s):
            if self.raft.role != RaftRole.LEADER:
                continue
            with self._state_lock:
                pairs = [
                    (nid, m.state, self.detector.state_of(nid))
                    for nid, m in self.members.items()
                    if nid != self.node_id
                ]
            for nid, replicated, observed in pairs:
                try:
                    if observed == NodeState.HEALTHY and replicated == NodeState.FAILED:
                        self._propose({"op": "node_recovered", "node_id": nid})
                    elif observed == NodeState.FAILED and replicated in (
                        NodeState.HEALTHY, NodeState.RECOVERING
                    ):
                        self._propose({"op": "node_failed", "node_id": nid})
                except Exception:
                    pass

    def _recovery_loop(self) -> None:
        """Leader-only executor for queued data-movement recovery tasks
        (replica resync after placement repair). Runs outside the raft apply
        worker and outside _state_lock so shard transfers never stall applies
        or searches. Non-leaders keep their queues; whoever is leader when the
        work surfaces executes it (transfers are idempotent upserts)."""
        from grape_vector_db_tpu_torch.distributed.raft import RaftRole

        while not self._stop_reconcile.is_set():
            woke = self._recovery_wake.wait(self.config.heartbeat_interval_s)
            if self._stop_reconcile.is_set():
                return
            if woke:
                self._recovery_wake.clear()
            if self.raft.role != RaftRole.LEADER:
                continue
            if self.failover.queue_depth():
                try:
                    self.failover.run_pending()
                except Exception:
                    pass  # unreachable peer etc.; next wake retries

    # ------------------------------------------------------- metadata plane

    def _propose(self, command: Dict[str, Any], timeout_s: float = 3.0,
                 wait_applied: bool = False) -> None:
        data = msgpack.packb(command, use_bin_type=True)
        self.raft.propose_on_leader(data, timeout_s=timeout_s,
                                    wait_applied=wait_applied)

    def _group_of_shard(self, sid: int) -> int:
        # Keyed off the CONFIG count, not len(self.data_rafts): restore_fn
        # fires from RaftNode.__init__ while the data_rafts dict is still
        # being populated, and a len()-based modulo would misroute (or drop)
        # every shard of the not-yet-constructed groups during that window.
        n = self.config.data_raft_groups
        return sid % n if n else -1

    def _propose_groups(self, by_group: Dict[int, list], op: str,
                        field: str, encode=None) -> None:
        """STRONG write fan-out: per-shard-group commands commit through
        independent raft leaders concurrently (multi-raft — write throughput
        scales past one leader's pipeline). Uses a shared long-lived pool
        (hot write path: a per-call executor pays thread spawn/join every
        batch)."""
        items = [
            (g, {"op": op, field: (encode(v) if encode else v)})
            for g, v in by_group.items()
        ]
        if len(items) <= 1:
            for g, cmd in items:
                self._propose_data(g, cmd)
            return
        futs = [self._mraft_pool.submit(self._propose_data, g, cmd)
                for g, cmd in items]
        for f in futs:
            f.result()

    @functools.cached_property
    def _mraft_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.data_raft_groups),
            thread_name_prefix=f"gvdb-mraft-{self.node_id}",
        )

    def _propose_data(self, group: int, command: Dict[str, Any],
                      timeout_s: float = 5.0) -> None:
        """STRONG data command via its shard group (or the main group when
        multi-raft is off). Always wait_applied: the coordinator's local state
        must cover the write before session versions are read."""
        data = msgpack.packb(command, use_bin_type=True)
        raft = self.raft if group < 0 else self.data_rafts[group]
        raft.propose_on_leader(data, timeout_s=timeout_s, wait_applied=True)

    def _snapshot_versions(self) -> bytes:
        with self._version_lock:
            return msgpack.packb(
                {"versions": {str(k): v for k, v in self.shard_versions.items()}},
                use_bin_type=True,
            )

    def _restore_versions(self, blob: bytes, group: int = -1) -> None:
        """Data-group InstallSnapshot restore. The snapshot carries ONLY the
        version counters — the documents of the compacted entries are not in
        it — so bumping the counters immediately would let token-carrying
        session reads pass while the writes are still missing on this node.
        Instead: consider only THIS group's shards (a group's snapshot must
        not inflate counters the other groups own) and hand each to the
        resync worker, which pulls the shard from another owner and bumps
        the counter only AFTER its data landed. Until then session reads see
        the shard as unready -> 'stale' -> the scatter-gather retries the
        primary (cluster.py::search)."""
        st = msgpack.unpackb(blob, raw=False)
        versions = {
            int(k): v for k, v in st.get("versions", {}).items()
            if group < 0 or self._group_of_shard(int(k)) == group
        }
        if not versions:
            return
        # A snapshot install means this node's replay has a compacted gap:
        # whatever completeness it held (possibly restored from disk) is no
        # longer provable for shards the snapshot advances past its local
        # counters — demote them before the resync re-earns the flag.
        with self._version_cv:
            changed = False
            for sid, v in versions.items():
                if (v > self.shard_versions.get(sid, 0)
                        and sid in self._complete_shards):
                    self._complete_shards.discard(sid)
                    changed = True
            if changed:
                self._persist_complete()
        self._schedule_resync(versions)

    # -------------------------------------------------- shard data resync

    def _owned_shard_set(self) -> Set[int]:
        """Caller must hold _state_lock."""
        return {
            sid for sid, info in self.shard_map.shards.items()
            if self.node_id in info.all_nodes()
        }

    def _schedule_resync(self, targets: Dict[int, int]) -> None:
        """Mark shards unready and queue them for the background resync
        worker. ``targets`` maps shard id -> version counter to adopt once
        the data landed (0 when the counter is already correct and only the
        documents are missing — e.g. ownership gained via placement
        change)."""
        with self._version_cv:
            self._unready_shards.update(targets)
        with self._resync_lock:
            for sid, v in targets.items():
                self._resync_targets[sid] = max(
                    self._resync_targets.get(sid, 0), v)
        self._resync_wake.set()

    def _resync_loop(self) -> None:
        """Background shard-data resync (the node-side half of failover's
        DATA_RESYNC, and the healer for every way a node can own a shard
        whose writes it missed: snapshot-installed counters, placements that
        applied after the shard's data commands, rebalancing). Pulls each
        pending shard from another owner, then marks it ready; until then
        token-carrying searches report it stale."""
        backoff = self.config.heartbeat_interval_s
        while not self._stop_reconcile.is_set():
            self._resync_wake.wait(backoff)
            if self._stop_reconcile.is_set():
                return
            self._resync_wake.clear()
            with self._resync_lock:
                pending = dict(self._resync_targets)
            for sid, target in sorted(pending.items()):
                if self._stop_reconcile.is_set():
                    return
                try:
                    settled = self._try_resync_shard(sid, target)
                except Exception:
                    logger.exception("%s: resync of shard %d failed",
                                     self.node_id, sid)
                    settled = False  # retry on the next wake
                if settled:
                    with self._resync_lock:
                        # only clear if no higher target arrived meanwhile
                        if self._resync_targets.get(sid, 0) <= target:
                            self._resync_targets.pop(sid, None)
            self._relinquish_tick += 1
            if self._relinquish_tick % 5 == 0:
                try:
                    self._relinquish_complete()
                except Exception:
                    logger.exception("%s: relinquish sweep failed",
                                     self.node_id)

    def _relinquish_complete(self) -> None:
        """Anti-entropy: an old owner keeps absorbing a complete shard's
        writes after losing ownership (so resyncs always have a data-holding
        source); once every CURRENT owner reports the shard complete, the
        obligation ends and this node stops absorbing."""
        with self._version_lock:
            complete = set(self._complete_shards)
        with self._state_lock:
            owner_sets: Dict[int, List[str]] = {}
            for sid in complete:
                info = self.shard_map.shards.get(sid)
                if (info is None or not info.primary_node
                        or self.node_id in info.all_nodes()):
                    continue
                owner_sets[sid] = [
                    n for n in [info.primary_node, *info.replica_nodes]
                    if n and n != self.node_id
                ]
        if not owner_sets:
            return
        # One batched data_version call per owner node — serial per-shard
        # probes would block the resync worker (2 s timeout each) and starve
        # the actual resyncs this thread exists for.
        by_node: Dict[str, List[int]] = {}
        for sid, owners in owner_sets.items():
            for n in owners:
                by_node.setdefault(n, []).append(sid)
        complete_on: Dict[str, Optional[Set[int]]] = {}
        for n, sids in by_node.items():
            try:
                resp = self._call(n, "data_version", {"shards": sids},
                                  timeout_s=2.0)
                complete_on[n] = set(resp.get("complete", []))
            except Exception:
                complete_on[n] = None  # unreachable — keep absorbing
        for sid, owners in owner_sets.items():
            done = owners and all(
                complete_on.get(n) is not None and sid in complete_on[n]
                for n in owners
            )
            if not done:
                continue
            # Relinquish is a HANDOFF, not a trust-based drop. An owner's
            # complete flag can be stale in direct-replication mode: a
            # deposed owner stops receiving writes the moment placement
            # changes, so a resync chain that sourced from it (while the
            # true holder was down) yields owners that claim completeness
            # yet miss writes only this node still holds — dropping on the
            # flag alone then erases acknowledged data cluster-wide
            # (observed in the chaos suite: surviving=0/27). Push the local
            # copy to every current owner first (upsert-if-newer, so a
            # stale doc revision never clobbers a later update), and drop
            # only after every owner acked every chunk.
            local = [rec.to_document().to_dict()
                     for rec in self.db.store.iter_records()
                     if self._shard_of_record(rec.id) == sid]
            if local:
                # chunked: one whole-shard message would blow the gRPC
                # transport's 4 MB default frame cap and wedge relinquish
                # forever on production transport
                acked = True
                for n in owners:
                    for i in range(0, len(local), 128):
                        try:
                            self._call(n, "data_reconcile",
                                       {"docs": local[i:i + 128]},
                                       timeout_s=10.0)
                        except Exception:
                            acked = False
                            break
                    if not acked:
                        break
                if not acked:
                    continue  # retry on a later sweep
            # Drop ONLY what was pushed, atomically against concurrent
            # absorbs: a write landing during the (slow) push window is
            # either a newer revision of a pushed id or a brand-new id —
            # both make the sweep dirty; keep the complete flag and retry
            # on a later sweep so nothing is deleted un-pushed or stranded
            # un-tracked. Lock order: db.write_lock, then _version_lock
            # (no path acquires them in reverse).
            pushed_at = {d["id"]: d.get("updated_at", 0) for d in local}
            with self.db.write_lock:
                drop, dirty = [], False
                for rec in self.db.store.iter_records():
                    if self._shard_of_record(rec.id) != sid:
                        continue
                    pushed = pushed_at.get(rec.id)
                    if pushed is not None and rec.updated_at <= pushed:
                        drop.append(rec.id)
                    else:
                        dirty = True
                if dirty:
                    continue
                # Every current owner now provably holds this node's copy;
                # a lingering local copy would serve stale hits from this
                # node's whole-corpus local search (and double-count
                # capacity). Placement decides redundancy.
                with self._version_lock:
                    self._complete_shards.discard(sid)
                    self._persist_complete()
                if drop:
                    self.db.batch_delete_documents(drop)

    def _try_resync_shard(self, sid: int, target: int) -> bool:
        """One resync attempt; returns True when the shard is settled (data
        pulled from a COMPLETE source, or positively not ours). False =
        retry on the next wake."""
        logger.debug("%s: resync attempt shard=%d target=%d",
                     self.node_id, sid, target)
        with self._state_lock:
            info = self.shard_map.shards.get(sid)
            if info is None or not info.primary_node:
                return False  # placement not known yet — retry later
            mine = self.node_id in info.all_nodes()
            owners = [
                n for n in [info.primary_node, *info.replica_nodes]
                if n and n != self.node_id
            ]
            others = [n for n in self.healthy_node_ids()
                      if n != self.node_id and n not in owners]
        if not mine:
            # Not an owner: adopt the counter (harmless — this node is never
            # targeted for the shard) and stop tracking it.
            self._settle_shard(sid, target, complete=False)
            return True
        # Source selection: highest-counter COMPLETE holder, current owners
        # preferred. Counters bump on every applier (pure function of the
        # group log), so a high counter alone proves nothing about data —
        # after a placement change the whole owner set can rotate onto
        # nodes that are themselves mid-resync, and an old owner outside the
        # placement may be the only node actually holding the documents.
        best_src, best_v = None, -1
        all_zero, any_unreachable = True, False
        for src in [*owners, *others]:
            try:
                resp = self._call(src, "data_version", {"shards": [sid]},
                                  timeout_s=2.0)
            except Exception:
                any_unreachable = True
                continue
            v = resp["versions"].get(str(sid), 0)
            if v > 0:
                all_zero = False
            if sid in resp.get("complete", []) and v > best_v:
                best_src, best_v = src, v
        if best_src is None:
            with self._version_lock:
                local_v = self.shard_versions.get(sid, 0)
            if (all_zero and not any_unreachable and local_v == 0
                    and target == 0):
                # Bootstrap: the shard has never seen a write anywhere —
                # there is nothing to recover; this node's (empty) copy IS
                # complete.
                self._settle_shard(sid, 0)
                return True
            if not owners and not any_unreachable:
                # Sole owner, and no reachable node anywhere holds the shard
                # complete: our local copy is the best that exists (e.g. a
                # replica_count=1 restart) — settle rather than wait forever
                # on non-owners that will never have the data.
                self._settle_shard(sid, target)
                return True
            return False  # no complete holder reachable — retry later
        try:
            resp = self._call(best_src, "data_pull", {"shard_id": sid},
                              timeout_s=10.0)
            docs = [Document.from_dict(d) for d in resp["docs"]]
            if docs:
                self.db.batch_add_documents(docs)
        except Exception:
            return False
        if best_v < target:
            # The complete holder hasn't caught up to the counter level this
            # node must vouch for (e.g. a snapshot from a farther-ahead
            # leader): incorporate its data, advance only to the version it
            # actually covers, retry for the rest.
            with self._version_cv:
                self.shard_versions[sid] = max(
                    self.shard_versions.get(sid, 0), best_v)
                self._version_cv.notify_all()
            return False
        self._settle_shard(sid, max(target, best_v))
        return True

    def _persist_complete(self) -> None:
        """Caller holds _version_lock."""
        try:
            self.db.store.put_kv(
                f"gvdb_complete_{self.node_id}",
                msgpack.packb(sorted(self._complete_shards)),
            )
        except Exception:  # store closing during shutdown
            pass

    def _settle_shard(self, sid: int, version: int,
                      complete: bool = True) -> None:
        with self._version_cv:
            self.shard_versions[sid] = max(
                self.shard_versions.get(sid, 0), version)
            self._unready_shards.discard(sid)
            if complete and sid not in self._complete_shards:
                self._complete_shards.add(sid)
                self._persist_complete()
            self._version_cv.notify_all()

    def _apply_command(self, entry: LogEntry) -> None:
        cmd = msgpack.unpackb(entry.data, raw=False)
        op = cmd.get("op")
        # Data commands take the state lock only for the shard-map read —
        # the store/index write happens outside it so the independent raft
        # groups' apply workers actually run in parallel (the point of
        # multi-raft); per-shard ordering still holds because a shard's
        # commands all flow through one group's single ordered apply worker.
        if op == "data_upsert":
            with self._state_lock:
                with self._version_lock:
                    complete = set(self._complete_shards)
                # Store docs this node owns per its CURRENT map, plus docs of
                # shards it is still COMPLETE on (an old owner keeps absorbing
                # until the new owners finish resyncing — otherwise the data
                # could rotate onto nodes that never held it).
                mine = []
                for d in cmd["docs"]:
                    sid = self.shard_map.shard_for_key(d["id"])
                    if (sid in complete or self.node_id
                            in self.shard_map.shards[sid].all_nodes()):
                        mine.append(d)
                self._applied_commands += 1
            if mine:
                self.db.batch_add_documents([Document.from_dict(d) for d in mine])
            # Version counters are a pure function of each group's log (every
            # applier bumps every affected shard), so they agree cluster-wide.
            # If this node's shard map lags the main group and it skipped docs
            # it will turn out to own, the ownership-gain hook in the metadata
            # apply path marks those shards unready and resyncs them — the
            # counter alone never vouches for local data.
            self._bump_shard_versions([d["id"] for d in cmd["docs"]])
            return
        if op == "data_delete":
            self.db.batch_delete_documents(cmd["ids"])
            self._bump_shard_versions(cmd["ids"])
            with self._state_lock:
                self._applied_commands += 1
            return
        with self._state_lock:
            # Placement-mutating commands: diff this node's owned-shard set
            # around the mutation. Ownership GAINED here means the shard's
            # data commands may have applied (through an independent data
            # raft group) while this node's shard map still excluded it —
            # those documents were skipped, so the shard must resync before
            # session reads trust it (the counters, a pure function of the
            # group log, are already up to date and therefore prove nothing
            # about local data).
            owned_before = (self._owned_shard_set()
                            if op in ("join", "leave", "node_failed",
                                      "set_placement") else None)
            if op == "join":
                info = NodeInfo(node_id=cmd["node_id"], address=cmd["address"])
                self.members[cmd["node_id"]] = info
                # runtime joins carry the new node's address — teach the
                # transport (gRPC address book) so every applier can reach it
                set_addr = getattr(self.transport, "set_address", None)
                if set_addr is not None and cmd.get("address"):
                    set_addr(cmd["node_id"], cmd["address"])
                self.load_balancer.add_node(info)
                if cmd["node_id"] != self.node_id:
                    self.detector.watch(cmd["node_id"])
                self._reassign_shards()
            elif op == "leave":
                self.members.pop(cmd["node_id"], None)
                self.load_balancer.remove_node(cmd["node_id"])
                self.detector.unwatch(cmd["node_id"])
                self.shard_map.remove_node(cmd["node_id"])
                self._reassign_shards()
            elif op == "node_failed":
                if cmd["node_id"] in self.members:
                    self.members[cmd["node_id"]].state = NodeState.FAILED
                    self.load_balancer.set_node_state(cmd["node_id"], NodeState.FAILED)
                    # Placement repair runs deterministically on every applier
                    # (pure function of replicated state — all maps converge);
                    # the returned data-resync tasks are executed by the
                    # LEADER's background recovery worker only, outside this
                    # apply path — running blocking shard transfers here would
                    # stall every subsequent apply on every node and move the
                    # same data N times.
                    healthy = sorted(
                        nid for nid, m in self.members.items()
                        if m.state in (NodeState.HEALTHY, NodeState.RECOVERING)
                    )
                    resync = self.failover.apply_placement_for_failure(
                        cmd["node_id"], healthy
                    )
                    self.failover.enqueue_tasks(resync)
                    self._recovery_wake.set()
            elif op == "node_recovered":
                if cmd["node_id"] in self.members:
                    self.members[cmd["node_id"]].state = NodeState.HEALTHY
                    self.load_balancer.set_node_state(cmd["node_id"], NodeState.HEALTHY)
            elif op == "set_placement":
                self.shard_map.set_placement(
                    cmd["shard_id"], cmd["primary"], cmd["replicas"]
                )
            self._applied_commands += 1
            if owned_before is not None:
                gained = self._owned_shard_set() - owned_before
            else:
                gained = set()
        if gained:
            self._schedule_resync({sid: 0 for sid in gained})

    def _snapshot_state(self) -> bytes:
        with self._state_lock:
            return msgpack.packb({
                "members": [
                    {"node_id": m.node_id, "address": m.address,
                     "state": m.state.value}
                    for m in self.members.values()
                ],
                "placements": {
                    str(sid): [i.primary_node, list(i.replica_nodes)]
                    for sid, i in self.shard_map.shards.items()
                },
                "applied": self._applied_commands,
            }, use_bin_type=True)

    def _restore_state(self, blob: bytes) -> None:
        st = msgpack.unpackb(blob, raw=False)
        with self._state_lock:
            owned_before = self._owned_shard_set()
            self.members = {}
            set_addr = getattr(self.transport, "set_address", None)
            for m in st["members"]:
                info = NodeInfo(node_id=m["node_id"], address=m["address"],
                                state=NodeState(m["state"]))
                self.members[m["node_id"]] = info
                self.load_balancer.add_node(info)
                if m["node_id"] != self.node_id:
                    self.detector.watch(m["node_id"])
                if set_addr is not None and m.get("address"):
                    set_addr(m["node_id"], m["address"])
            for sid, (primary, replicas) in st["placements"].items():
                if primary:
                    self.shard_map.set_placement(int(sid), primary, replicas)
            self._applied_commands = st.get("applied", 0)
            gained = self._owned_shard_set() - owned_before
        if gained:
            # snapshot-installed placements: any shard this node now owns may
            # have writes it never applied — resync before serving sessions
            self._schedule_resync({sid: 0 for sid in gained})

    def _reassign_shards(self) -> None:
        live = sorted(
            nid for nid, m in self.members.items()
            if m.state in (NodeState.HEALTHY, NodeState.RECOVERING)
        )
        if live:
            self.shard_map.assign_all(live)

    # -- membership API ------------------------------------------------------------

    def join_cluster(self) -> None:
        """Propose own membership (cluster.rs:97-182). A seeded node is
        already a raft voter, so the proposal forwards to the leader; a
        runtime joiner is NOT a voter yet — the leader never contacts it, no
        hint arrives, and the proposal cannot land. In that case ask a seed
        peer to splice us in (raft voter sets + join) via cluster_join."""
        try:
            self._propose({"op": "join", "node_id": self.node_id,
                           "address": self.address}, timeout_s=3.0)
            return
        except Exception as e:
            last: Exception = e
        for peer in [v for v in self.raft.voters if v != self.node_id]:
            try:
                self._call(peer, "cluster_join",
                           {"node_id": self.node_id, "address": self.address},
                           timeout_s=20.0)
                return
            except Exception as e:
                last = e
        raise last

    def _rpc_cluster_join(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Peer-side runtime join: splice a NEW node into every raft group's
        voter set, or just re-announce a seeded one."""
        node_id = payload["node_id"]
        address = payload.get("address") or None
        set_addr = getattr(self.transport, "set_address", None)
        if set_addr is not None and address:
            set_addr(node_id, address)
        # Check EVERY group, not just the metadata raft: a retried join after
        # a partial add_member (some groups spliced, some timed out) must
        # finish the remaining groups, or the joiner silently misses those
        # groups' writes forever. add_member skips groups that already have
        # the voter, so the retry converges.
        missing = any(
            node_id not in r.voters
            for r in [self.raft, *self.data_rafts.values()]
        )
        if missing:
            self.add_member(node_id, address=address)
        else:
            self._propose({"op": "join", "node_id": node_id,
                           "address": address or ""})
        return {"ok": True}

    def leave_cluster(self) -> None:
        """Graceful leave with shard handoff via re-assignment (cluster.rs:184-276)."""
        self._propose({"op": "leave", "node_id": self.node_id})

    def add_member(self, node_id: str, address: Optional[str] = None,
                   timeout_s: float = 10.0) -> None:
        """Runtime membership expansion (beyond the reference's fixed seed
        set): add ``node_id`` as a raft voter in the metadata group AND every
        data group (each change commits through that group's own leader),
        then replicate the join so placements include it. The new node must
        already be reachable on the transport (for gRPC, via
        GRAPE_NODE_{ID}_ADDRESS or the address book).

        Call AFTER the new node's ClusterNode is constructed and started —
        it needs to answer append_entries to catch up."""
        if address is None:
            info = self.members.get(node_id)
            address = info.address if info else ""
        # timeout_s is a TOTAL budget across all raft groups — a dead leader
        # in one group must not multiply the caller's wait by the group count
        deadline = time.monotonic() + timeout_s
        for raft in [self.raft, *self.data_rafts.values()]:
            self._change_group_membership(
                raft, add=node_id,
                timeout_s=max(deadline - time.monotonic(), 0.05))
        self._propose({"op": "join", "node_id": node_id, "address": address})

    def remove_member(self, node_id: str, timeout_s: float = 10.0) -> None:
        """Runtime membership removal: drop the node from every raft group's
        voter set and replicate the leave (shards re-assign to survivors)."""
        self._propose({"op": "leave", "node_id": node_id})
        deadline = time.monotonic() + timeout_s
        for raft in [self.raft, *self.data_rafts.values()]:
            self._change_group_membership(
                raft, remove=node_id,
                timeout_s=max(deadline - time.monotonic(), 0.05))

    @staticmethod
    def _change_group_membership(raft: RaftNode, add: Optional[str] = None,
                                 remove: Optional[str] = None,
                                 timeout_s: float = 10.0) -> None:
        """Idempotent single-node add/remove on one raft group. Recomputes
        the target set from the group's CURRENT voters on every attempt and
        retries conflicts (concurrent membership ops, in-flight configs) —
        a one-shot set computed from a stale view could change two servers
        at once or undo a concurrent change."""
        deadline = time.monotonic() + timeout_s
        while True:
            voters = set(raft.voters)
            if add is not None:
                if add in voters:
                    return  # already spliced (retry after partial failure)
                desired = voters | {add}
            else:
                if remove not in voters:
                    return
                desired = voters - {remove}
                if not desired:
                    raise ConsensusError("cannot remove the last voter")
            try:
                raft.membership_on_leader(
                    sorted(desired),
                    timeout_s=max(deadline - time.monotonic(), 0.05))
                return
            except ConsensusError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)  # conflicting change in flight — recompute

    def healthy_node_ids(self) -> List[str]:
        with self._state_lock:
            return [nid for nid, m in self.members.items()
                    if m.state in (NodeState.HEALTHY, NodeState.RECOVERING)]

    # ------------------------------------------------------------ failure path

    def _probe_peer(self, node_id: str) -> bool:
        try:
            resp = self._call(node_id, "heartbeat", {
                "node_id": self.node_id, "term": self.raft.current_term,
            }, timeout_s=1.0)
            return bool(resp.get("ok"))
        except TransportError:
            return False

    def _on_peer_state_change(self, node_id: str, state: NodeState) -> None:
        if not self._started:
            return
        try:
            if state == NodeState.FAILED:
                self._propose({"op": "node_failed", "node_id": node_id})
            elif state == NodeState.HEALTHY:
                self._propose({"op": "node_recovered", "node_id": node_id})
        except Exception:
            pass  # a non-leader race or no quorum; detector will fire again

    def _rpc_heartbeat(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        self.load_balancer.mark_heartbeat(payload.get("node_id", ""))
        return {"ok": True, "term": self.raft.current_term, "node_id": self.node_id}

    # --------------------------------------------------------------- data plane

    def _shard_of_record(self, rec_id: str) -> int:
        return self.shard_map.shard_for_key(rec_id)

    def _replica_write(self, node_id: str, docs: List[Dict[str, Any]]) -> int:
        resp = self._call(node_id, "data_write", {"docs": docs}, timeout_s=5.0)
        return resp["written"]

    def _bump_shard_versions(self, ids: Sequence[str]) -> Dict[int, int]:
        """Advance the per-shard version once per affected shard; returns the
        new versions. Every replica applies the same writes, so counters on
        caught-up replicas agree with the primary's."""
        shards = {self._shard_of_record(i) for i in ids}
        with self._version_cv:
            out = {}
            for sid in shards:
                self.shard_versions[sid] = self.shard_versions.get(sid, 0) + 1
                out[sid] = self.shard_versions[sid]
            self._version_cv.notify_all()
            return out

    def _wait_shard_versions(self, min_versions: Dict[int, int]) -> List[int]:
        """Block (bounded) until local versions reach min_versions; returns
        the shard ids still behind at the deadline."""
        deadline = time.monotonic() + self.session_wait_s
        with self._version_cv:
            while True:
                behind = [sid for sid, v in min_versions.items()
                          if self.shard_versions.get(sid, 0) < v]
                if not behind:
                    return []
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return behind
                self._version_cv.wait(remaining)

    def _rpc_data_write(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        docs = [Document.from_dict(d) for d in payload["docs"]]
        self.db.batch_add_documents(docs)
        versions = self._bump_shard_versions([d.id for d in docs])
        return {"written": len(docs), "node_id": self.node_id,
                "versions": {str(s): v for s, v in versions.items()}}

    def _rpc_data_delete(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        deleted = self.db.batch_delete_documents(payload["ids"])
        versions = self._bump_shard_versions(payload["ids"])
        return {"deleted": deleted,
                "versions": {str(s): v for s, v in versions.items()}}

    def _rpc_data_version(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        with self._version_lock:
            return {
                "versions": {
                    str(sid): self.shard_versions.get(int(sid), 0)
                    for sid in payload["shards"]
                },
                # data-completeness signal for resync source selection —
                # counters alone bump on every node and prove nothing
                "complete": [int(sid) for sid in payload["shards"]
                             if int(sid) in self._complete_shards],
            }

    def _rpc_data_search(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        stale: List[int] = []
        min_versions = payload.get("min_versions")
        if min_versions:
            stale = self._wait_shard_versions(
                {int(k): v for k, v in min_versions.items()}
            )
            # A shard mid-resync has correct counters but possibly missing
            # documents — the version gate proves nothing for it. Report it
            # stale so the coordinator retries at a settled owner.
            with self._version_lock:
                stale += [int(k) for k in min_versions
                          if int(k) in self._unready_shards
                          and int(k) not in stale]
        # Budget covers a worst-case cold jit compile AND congested-relay
        # stalls (observed >120 s): abandoning the future doesn't cancel the
        # device work, it just loses the answer the queue will produce
        # anyway, so the handler waits long and the CALLER's transport
        # deadline + failed-leg replica retry handle truly lost nodes.
        hits = self._search_batcher.search(
            np.asarray(payload["vector"], dtype=np.float32),
            int(payload["k"]), timeout_s=600.0)
        return {"hits": [(h.id, h.score) for h in hits], "stale": stale}

    def _rpc_data_search_batch(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Batched scatter leg: Q query vectors in one RPC (coordinator-side
        _SearchLegBatcher packs them; ClusterNode.search_batch sends natural
        client batches). All Q submit to the device micro-batcher at once —
        the pack lands in shared launches with any concurrent traffic.
        An optional merged ``min_versions`` gate (per-shard MAX over the
        pack) is waited once for the whole pack."""
        stale: List[int] = []
        min_versions = payload.get("min_versions")
        if min_versions:
            stale = self._wait_shard_versions(
                {int(k): v for k, v in min_versions.items()}
            )
            with self._version_lock:
                stale += [int(k) for k in min_versions
                          if int(k) in self._unready_shards
                          and int(k) not in stale]
        k = int(payload["k"])
        futs = [self._search_batcher.submit(
                    np.asarray(v, dtype=np.float32), k)
                for v in payload["vectors"]]
        per_q = [[(h.id, h.score) for h in f.result(timeout=600.0)]
                 for f in futs]
        return {"hits_per_query": per_q, "stale": stale}

    def _rpc_data_count(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        sid = payload["shard_id"]
        n = sum(1 for rid in self.db.store.iter_ids()
                if self._shard_of_record(rid) == sid)
        return {"count": n}

    def _rpc_data_get(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Point lookups for scatter-gather result materialization (payloads
        live on the owning nodes, not the coordinator)."""
        docs = []
        for rid in payload["ids"]:
            rec = self.db.store.get(rid)
            if rec is not None:
                docs.append(rec.to_document().to_dict())
        return {"docs": docs}

    def _rpc_data_pull(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        sid = payload["shard_id"]
        docs = []
        for rec in self.db.store.iter_records():
            if self._shard_of_record(rec.id) == sid:
                docs.append(rec.to_document().to_dict())
        return {"docs": docs}

    def _rpc_data_reconcile(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Anti-entropy upsert-if-newer: accept each doc only when it is
        locally absent or the incoming revision is strictly newer
        (``updated_at``). Used by the relinquish handoff so an old owner's
        copy can never clobber a later update on a current owner, while
        writes only the old owner still holds are preserved.

        The compare and the conditional upsert run under the db write lock
        as one atomic step — otherwise a concurrent client write landing
        between them would be silently overwritten by the older pushed
        revision (permanent replica divergence). No shard-version bump:
        reconciled docs carry no session token, and bumping only the
        owners that happened to accept would skew the counter agreement
        the SESSION read gate relies on."""
        accepted = []
        with self.db.write_lock:
            for d in payload["docs"]:
                local = self.db.store.get(d["id"])
                if local is None or local.updated_at < d.get("updated_at", 0):
                    accepted.append(Document.from_dict(d))
            if accepted:
                self.db.batch_add_documents(accepted)
        return {"accepted": len(accepted), "node_id": self.node_id}

    def _rpc_data_drop(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        sid = payload["shard_id"]
        ids = [rid for rid in self.db.store.iter_ids()
               if self._shard_of_record(rid) == sid]
        return {"dropped": self.db.batch_delete_documents(ids)}

    # -- client API -------------------------------------------------------------------

    def _wait_placements(self, shard_ids, timeout_s: float = 5.0) -> None:
        """Bounded bootstrap grace: a node that just joined sees the shard
        map populate when the raft-replicated join/assign commands apply —
        failing a write in that window is needless unavailability. Raises
        UnavailableError only if placement never arrives."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._state_lock:
                missing = [sid for sid in shard_ids
                           if not self.shard_map.shards[sid].primary_node]
            if not missing:
                return
            if time.monotonic() >= deadline:
                raise UnavailableError(
                    f"shard map has no placement for shards {missing[:4]}"
                )
            time.sleep(0.02)

    def upsert(self, docs: Sequence[Document],
               session: Optional[SessionToken] = None) -> int:
        """Shard-routed replicated write (the write path of shard.rs:634-719,
        for real). Under STRONG consistency the batch goes through the raft
        log (VectorCommand semantics) so every owner applies it in the same
        order; otherwise the replication manager writes copies directly.

        Passing a ``session`` records the primaries' post-write shard
        versions into it; later searches carrying the token are guaranteed
        to observe these writes (read-your-writes)."""
        if not docs:
            return 0
        if self.config.consistency == ConsistencyLevel.STRONG:
            # Refuse before proposing if any target shard has no placement —
            # otherwise the commit applies to nobody and the write is lost
            # while reporting success. (Bounded wait: boot-time placements
            # arrive via raft apply moments after start.)
            self._wait_placements(
                {self.shard_map.shard_for_key(d.id) for d in docs}
            )
            by_group: Dict[int, List[Document]] = {}
            for d in docs:
                g = self._group_of_shard(self._shard_of_record(d.id))
                by_group.setdefault(g, []).append(d)
            self._propose_groups(
                by_group, "data_upsert", "docs",
                encode=lambda group_docs: [d.to_dict() for d in group_docs],
            )
            if session is not None:
                # this node applied the command (wait_applied): local
                # versions already cover the write
                with self._version_lock:
                    for d in docs:
                        sid = self._shard_of_record(d.id)
                        session.observe(sid, self.shard_versions.get(sid, 0))
            return len(docs)
        by_shard: Dict[int, List[Document]] = {}
        for d in docs:
            by_shard.setdefault(self._shard_of_record(d.id), []).append(d)
        self._wait_placements(set(by_shard))
        written = 0
        for sid, group in by_shard.items():
            payload = [d.to_dict() for d in group]
            # Bounded failover grace: a primary that just died stays in the
            # placement until the detector (3 missed beats) + raft repair
            # replace it — failing every write in that window is needless
            # unavailability when a retry lands on the promoted replica.
            # Retry discipline by FAILURE STAGE: a failed primary WRITE
            # never landed (the primary is dead or dying — detection lags a
            # beat), so retrying until failover re-points it is safe and
            # duplicates nothing. Failed replica ACKS mean the primary write
            # DID land — retry only when the placement changed, or each
            # attempt re-sends the payload to a healthy primary.
            deadline = time.monotonic() + max(
                5.0, 6 * self.config.heartbeat_interval_s)
            while True:
                with self._state_lock:
                    info = self.shard_map.shards[sid]
                    primary, replicas = info.primary_node, list(info.replica_nodes)
                placement = (primary, tuple(replicas))
                try:
                    self.replication.replicate(payload, primary, replicas)
                    break
                except ReplicationError as e:
                    if time.monotonic() >= deadline:
                        raise
                    if getattr(e, "stage", "") == "primary":
                        # nothing landed — safe to re-send as soon as
                        # failover re-points the primary
                        time.sleep(0.1)
                        continue
                    # The primary write LANDED; only replica acks fell short
                    # (e.g. a dead replica awaiting top-up). Wait for the
                    # PLACEMENT to change before retrying — re-sending
                    # against the same placement just re-writes the primary
                    # for the same ack outcome.
                    changed = False
                    while time.monotonic() < deadline:
                        with self._state_lock:
                            info = self.shard_map.shards[sid]
                            now_p = (info.primary_node,
                                     tuple(info.replica_nodes))
                        if now_p != placement:
                            changed = True
                            break
                        time.sleep(0.1)
                    if not changed:
                        raise
            written += len(group)
            if session is not None:
                resp = self._call(primary, "data_version",
                                  {"shards": [sid]}, timeout_s=2.0)
                session.observe(sid, resp["versions"][str(sid)])
        return written

    def delete(self, ids: Sequence[str],
               session: Optional[SessionToken] = None) -> int:
        if not ids:
            return 0
        if self.config.consistency == ConsistencyLevel.STRONG:
            by_group: Dict[int, List[str]] = {}
            for i in ids:
                by_group.setdefault(
                    self._group_of_shard(self._shard_of_record(i)), []
                ).append(i)
            self._propose_groups(by_group, "data_delete", "ids")
            if session is not None:
                with self._version_lock:
                    for i in ids:
                        sid = self._shard_of_record(i)
                        session.observe(sid, self.shard_versions.get(sid, 0))
            return len(ids)
        by_shard: Dict[int, List[str]] = {}
        for i in ids:
            by_shard.setdefault(self._shard_of_record(i), []).append(i)
        deleted = 0
        for sid, group in by_shard.items():
            info = self.shard_map.shards[sid]
            for nid in info.all_nodes():
                try:
                    resp = self._call(nid, "data_delete", {"ids": group}, timeout_s=5.0)
                    if nid == info.primary_node:
                        deleted += resp["deleted"]
                        if session is not None:
                            session.observe(sid, resp["versions"][str(sid)])
                except TransportError:
                    pass
        return deleted

    def get_documents(self, ids: Sequence[str]) -> Dict[str, Document]:
        """Cross-shard point lookup: local store first, then each missing
        id's owner nodes (primary preferred). Used to materialize payloads
        for scatter-gather search results."""
        out: Dict[str, Document] = {}
        missing: List[str] = []
        for rid in ids:
            rec = self.db.store.get(rid)
            if rec is not None:
                out[rid] = rec.to_document()
            else:
                missing.append(rid)
        candidates: Dict[str, List[str]] = {}
        for rid in missing:
            with self._state_lock:
                info = self.shard_map.shards.get(self._shard_of_record(rid))
            if info is not None:
                candidates[rid] = [n for n in info.all_nodes()
                                   if n != self.node_id]
        # Owner preference order (primary first); ids a node fails to serve
        # (down, or lagging replica without the doc) fall through to the
        # shard's next owner instead of silently losing their payload.
        rnd = 0
        while True:
            by_node: Dict[str, List[str]] = {}
            for rid, owners in candidates.items():
                if rid not in out and rnd < len(owners):
                    by_node.setdefault(owners[rnd], []).append(rid)
            if not by_node:
                break
            for nid, rids in by_node.items():
                try:
                    resp = self._call(nid, "data_get", {"ids": rids},
                                      timeout_s=2.0)
                    for d in resp["docs"]:
                        out[d["id"]] = Document.from_dict(d)
                except TransportError:
                    pass
            rnd += 1
        return out

    def _leg_batcher(self, nid: str) -> _SearchLegBatcher:
        """Lazy per-target-node leg packer (created on first session-less
        scatter leg to ``nid``; lifetime = this coordinator's)."""
        with self._leg_batchers_lock:
            lb = self._leg_batchers.get(nid)
            if lb is None:
                lb = _SearchLegBatcher(
                    functools.partial(self._call_search_batch, nid),
                    max_batch=self.db.config.device.max_query_batch,
                    max_wait_ms=self.db.config.device.micro_batch_wait_ms,
                )
                self._leg_batchers[nid] = lb
            return lb

    def _call_search_batch(self, nid: str, payload: Dict[str, Any]
                           ) -> Dict[str, Any]:
        # deadline matches the handler's 600 s device budget (see
        # _rpc_data_search)
        return self._call(nid, "data_search_batch", payload, timeout_s=600.0)

    def search_batch(self, vectors: Sequence[Sequence[float]], k: int = 10,
                     session: Optional[SessionToken] = None,
                     stale_out: Optional[List[int]] = None
                     ) -> List[List[Tuple[str, float]]]:
        """Batched scatter-gather: Q client queries in ONE RPC per target
        node (the natural-batch form of ``search``; shard.rs:759-901 only
        ever fanned out single queries). With a ``session`` the pack waits
        once per node on the per-shard MAX of the token's versions — every
        query's read-your-writes bound is covered by the max. Shards still
        stale at the deadline are reported through ``stale_out`` (retry
        routing stays with the single-query path; a stale batch leg
        degrades to reporting rather than per-query primary retries)."""
        vecs = [list(v) for v in vectors]
        if not vecs:
            return []
        owners, primaries, healthy, alternates = self._scatter_targets()
        items = list(owners.items())

        def one_batch(nid: str, sids: Set[int]):
            payload: Dict[str, Any] = {"vectors": vecs, "k": k}
            if session is not None and session.versions:
                mv = {str(sid): session.versions[sid]
                      for sid in sids if sid in session.versions}
                if mv:
                    payload["min_versions"] = mv
            try:
                return self._call_search_batch(nid, payload)
            except TransportError:
                return None

        if len(items) > 1:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(items), thread_name_prefix="gvdb-scatter"
            ) as pool:
                responses = list(pool.map(lambda kv: one_batch(*kv), items))
        else:
            responses = [one_batch(nid, sids) for nid, sids in items]

        merged: List[Dict[str, float]] = [{} for _ in vecs]
        still_stale: Set[int] = set()
        for (nid, sids), resp in zip(items, responses):
            if resp is None:
                continue
            stale_sids = set(resp.get("stale", []))
            still_stale |= stale_sids & sids
            for qi, hits in enumerate(resp["hits_per_query"]):
                acc = merged[qi]
                for id_, score in hits:
                    if self._shard_of_record(id_) not in sids:
                        continue
                    if id_ not in acc or score > acc[id_]:
                        acc[id_] = score
        if stale_out is not None:
            stale_out.extend(sorted(still_stale))
        return [
            [(i, float(s))
             for i, s in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]
            for acc in merged
        ]

    def _scatter_targets(self):
        """(owners, primaries, healthy, alternates) under the same bounded
        bootstrap grace the single-query path applies (see ``search``).
        ``alternates[sid]`` lists every healthy owner of the shard in
        priority order (primary first) — the retry pool when a leg fails."""
        deadline = time.monotonic() + 5.0
        while True:
            with self._state_lock:
                owners: Dict[str, Set[int]] = {}
                alternates: Dict[int, List[str]] = {}
                healthy = set(self.healthy_node_ids())
                primaries = {sid: info.primary_node
                             for sid, info in self.shard_map.shards.items()}
                any_placed = any(p for p in primaries.values())
                for sid, info in self.shard_map.shards.items():
                    cands, seen = [], set()
                    for n in (info.primary_node, *info.replica_nodes):
                        if n in healthy and n not in seen:
                            seen.add(n)
                            cands.append(n)
                    if cands:
                        alternates[sid] = cands
                        owners.setdefault(cands[0], set()).add(sid)
            if owners or any_placed or time.monotonic() >= deadline:
                return owners, primaries, healthy, alternates
            time.sleep(0.02)

    def search(self, vector: Sequence[float], k: int = 10,
               session: Optional[SessionToken] = None,
               stale_out: Optional[List[int]] = None) -> List[Tuple[str, float]]:
        """Scatter-gather: one owner per shard, merged global top-k
        (shard.rs:759-901 — the real version of its mock).

        With a ``session`` token, each targeted node receives the minimum
        shard versions it must have applied; lagging replicas wait up to
        ``session_wait_s`` before serving. A replica still behind at its
        deadline is retried once against the shard's primary; shards that
        remain stale after that are appended to ``stale_out`` (and surfaced
        on the wire) instead of silently breaking the read-your-writes
        promise."""
        # Bounded bootstrap grace (read-path mirror of _wait_placements): a
        # node that just joined sees placements populate as the replicated
        # join/assign commands apply — serving an empty result in that window
        # reads as "no data" to the client, which is worse than a short wait.
        # Wait ONLY while the map has no placements at all: placements whose
        # owners are all unhealthy are a degraded cluster, and stalling every
        # query 5 s exactly then would turn a fast degraded answer into a
        # thundering pile-up of blocked server threads.
        owners, primaries, healthy, alternates = self._scatter_targets()

        def one(nid: str, sids: Set[int]):
            payload: Dict[str, Any] = {"vector": list(vector), "k": k}
            if session is not None and session.versions:
                mv = {str(sid): session.versions[sid]
                      for sid in sids if sid in session.versions}
                if mv:
                    payload["min_versions"] = mv
            try:
                if ("min_versions" not in payload
                        and self.db.config.device.coordinator_batch):
                    # Session-less leg: ride the per-node leg packer — one
                    # data_search_batch RPC per window instead of one RPC
                    # per concurrent search (timeout covers a worst-case
                    # cold jit compile through the relay behind the pack).
                    fut = self._leg_batcher(nid).submit(list(vector), k)
                    return fut.result(timeout=600.0)
                # Transport deadline matches the handler's 600 s device
                # budget: the leg's duration legitimately includes a cold
                # jit compile or a congested-relay stall on the remote node
                # (observed >120 s), and dropping a leg loses that shard's
                # results. Dead nodes still fail fast via TransportError +
                # the failure detector — the deadline only binds on
                # slow-but-alive nodes, where waiting beats returning a
                # partial top-k (a 5 s budget here measurably broke
                # scatter-gather during relay stalls: self-match 2/8).
                return self._call(nid, "data_search", payload,
                                  timeout_s=600.0)
            except (TransportError, concurrent.futures.TimeoutError):
                return None

        # Fan out concurrently: scatter latency is the slowest shard, not the
        # sum (and per-node session waits overlap instead of stacking).
        items = list(owners.items())
        if len(items) > 1:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(items), thread_name_prefix="gvdb-scatter"
            ) as pool:
                responses = list(pool.map(lambda kv: one(*kv), items))
        else:
            responses = [one(nid, sids) for nid, sids in items]

        merged: Dict[str, float] = {}
        still_stale: List[int] = []

        def merge(resp, only_shards: Set[int]) -> None:
            # Scope each node's hits to the shards it was TARGETED for: a
            # node's local search covers its whole corpus, including replica
            # copies of shards another node answers for — merging those
            # unscoped would let a lagging replica's stale docs bypass the
            # session gate through a response that never reported them stale.
            for id_, score in resp["hits"]:
                if self._shard_of_record(id_) not in only_shards:
                    continue
                if id_ not in merged or score > merged[id_]:
                    merged[id_] = score

        for (nid, sids), resp in zip(items, responses):
            if resp is None:
                # Leg failed: unreachable node, or a device launch stalled
                # past the handler's budget (seen for real behind relay
                # congestion). Dropping the shards silently returns a WRONG
                # top-k — retry each shard once at its next healthy owner
                # (RF>=2 keeps one); the stall that killed the first leg has
                # usually cleared by the time the retry lands. Shards with
                # no reachable owner are surfaced via stale_out rather than
                # silently absent.
                regroup: Dict[str, Set[int]] = {}
                for sid in sids:
                    alt = next((a for a in alternates.get(sid, [])
                                if a != nid), None)
                    if alt is not None:
                        regroup.setdefault(alt, set()).add(sid)
                    else:
                        still_stale.append(sid)
                for alt, alt_sids in regroup.items():
                    r2 = one(alt, alt_sids)
                    if r2 is None:
                        still_stale.extend(sorted(alt_sids))
                        continue
                    stale2 = set(r2.get("stale", [])) & alt_sids
                    merge(r2, only_shards=alt_sids - stale2)
                    if stale2:
                        merge(r2, only_shards=stale2)
                        still_stale.extend(sorted(stale2))
                continue
            stale_sids = set(resp.get("stale", []))
            # A stale shard's hits from this node may include deleted docs or
            # outdated scores — hold them back; the primary retry supplies
            # that shard's correct view (merging them first would let a stale
            # max-score win even after a successful retry).
            merge(resp, only_shards=sids - stale_sids)
            for sid in stale_sids:
                # A lagging replica served anyway; the primary has the write
                # by definition of the session token — retry there once.
                primary = primaries.get(sid)
                if primary and primary != nid and primary in healthy:
                    retry = one(primary, {sid})
                    if retry is not None and sid not in retry.get("stale", []):
                        merge(retry, only_shards={sid})
                        continue
                # Retry unavailable or still stale: fall back to the
                # replica's (possibly stale) hits rather than dropping the
                # shard, and say so via stale_out.
                merge(resp, only_shards={sid})
                still_stale.append(sid)
        if stale_out is not None:
            stale_out.extend(still_stale)
        ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:k]
        return [(i, float(s)) for i, s in ranked]

    # -- introspection --------------------------------------------------------------------

    def cluster_health(self) -> ClusterHealth:
        with self._state_lock:
            total = len(self.members)
            healthy = len(self.healthy_node_ids())
            shards = self.shard_map.snapshot()
            active = sum(1 for s in shards.values() if s.primary_node)
            under = sum(
                1 for s in shards.values()
                if len(s.all_nodes()) < min(self.config.replica_count, max(total, 1))
            )
            status = "healthy"
            if healthy < total:
                status = "degraded"
            if healthy <= total // 2:
                status = "critical"
            return ClusterHealth(
                status=status, total_nodes=total, healthy_nodes=healthy,
                total_shards=len(shards), active_shards=active,
                under_replicated_shards=under,
            )

    def cluster_info_dict(self) -> Dict[str, Any]:
        with self._state_lock:
            return {
                "cluster_id": self.config.cluster_id,
                "leader_id": self.raft.leader_id,
                "members": [m.to_dict() for m in self.members.values()],
                "shard_count": self.config.shard_count,
                "applied_commands": self._applied_commands,
            }

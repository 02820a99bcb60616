"""Failure detection + failover (reference src/distributed/failover.rs, 1338 LoC).

- FailureDetector: per-node heartbeat probing with a bounded history (50
  records), FAILED after 3 consecutive misses, recovered after 2 consecutive
  successes (failover.rs:82-718). The probe is a pluggable callable — the
  reference's bottomed out in a "node name contains 'fail'" simulation
  (failover.rs:652-668); here it's the transport's heartbeat.
- FailoverManager: node state machine Healthy/Suspected/Failed/Recovering/
  Offline (failover.rs:66-79), auto-failover pipeline producing prioritized
  RecoveryTasks (failover.rs:127-177, 376-425).
- RecoveryCoordinator: executes PrimaryFailover, ReplicaReplacement, DataResync,
  ShardReallocation against the shard map / cluster — the steps the reference
  logged but did not perform (failover.rs:858-890).
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from grape_vector_db_tpu_torch.distributed.shard import ShardManager
from grape_vector_db_tpu_torch.distributed.types import NodeState, ShardState

__all__ = [
    "HeartbeatRecord",
    "FailureDetector",
    "RecoveryTask",
    "RecoveryKind",
    "FailoverManager",
]


@dataclass
class HeartbeatRecord:
    timestamp: float
    success: bool
    latency_ms: float = 0.0


@dataclass
class _NodeProbe:
    history: Deque[HeartbeatRecord] = field(default_factory=lambda: deque(maxlen=50))
    consecutive_misses: int = 0
    consecutive_successes: int = 0
    state: NodeState = NodeState.HEALTHY


class FailureDetector:
    """Heartbeat prober (failover.rs:82-718)."""

    def __init__(
        self,
        probe_fn: Callable[[str], bool],
        interval_s: float = 1.0,
        fail_after: int = 3,
        recover_after: int = 2,
        on_state_change: Optional[Callable[[str, NodeState], None]] = None,
    ):
        self.probe_fn = probe_fn
        self.interval_s = interval_s
        self.fail_after = fail_after
        self.recover_after = recover_after
        self.on_state_change = on_state_change
        self._lock = threading.Lock()
        self._nodes: Dict[str, _NodeProbe] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, node_id: str) -> None:
        with self._lock:
            self._nodes.setdefault(node_id, _NodeProbe())

    def unwatch(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gvdb-failure-detector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.probe_all()

    def probe_all(self) -> None:
        with self._lock:
            targets = list(self._nodes)
        for nid in targets:
            t0 = time.perf_counter()
            try:
                ok = bool(self.probe_fn(nid))
            except Exception:
                ok = False
            self.record(nid, ok, (time.perf_counter() - t0) * 1e3)

    def record(self, node_id: str, success: bool, latency_ms: float = 0.0) -> None:
        changed: Optional[NodeState] = None
        with self._lock:
            p = self._nodes.setdefault(node_id, _NodeProbe())
            p.history.append(HeartbeatRecord(time.time(), success, latency_ms))
            if success:
                p.consecutive_successes += 1
                p.consecutive_misses = 0
                if p.state in (NodeState.FAILED, NodeState.SUSPECTED,
                               NodeState.RECOVERING):
                    if p.consecutive_successes >= self.recover_after:
                        p.state = NodeState.HEALTHY
                        changed = p.state
                    elif p.state == NodeState.FAILED:
                        p.state = NodeState.RECOVERING
                        changed = p.state
            else:
                p.consecutive_misses += 1
                p.consecutive_successes = 0
                if p.consecutive_misses >= self.fail_after:
                    if p.state != NodeState.FAILED:
                        p.state = NodeState.FAILED
                        changed = p.state
                elif p.state == NodeState.HEALTHY:
                    p.state = NodeState.SUSPECTED
                    changed = p.state
        if changed is not None and self.on_state_change is not None:
            self.on_state_change(node_id, changed)

    def state_of(self, node_id: str) -> NodeState:
        with self._lock:
            p = self._nodes.get(node_id)
            return p.state if p else NodeState.OFFLINE

    def states(self) -> Dict[str, NodeState]:
        with self._lock:
            return {nid: p.state for nid, p in self._nodes.items()}


class RecoveryKind:
    PRIMARY_FAILOVER = "primary_failover"
    REPLICA_REPLACEMENT = "replica_replacement"
    DATA_RESYNC = "data_resync"
    SHARD_REALLOCATION = "shard_reallocation"


@dataclass(order=True)
class RecoveryTask:
    priority: int
    created_at: float = field(compare=False)
    kind: str = field(compare=False, default="")
    node_id: str = field(compare=False, default="")
    shard_id: int = field(compare=False, default=-1)
    # For DATA_RESYNC: only these nodes need the shard pushed (freshly added
    # replicas); empty = all replicas.
    targets: List[str] = field(compare=False, default_factory=list)
    done: bool = field(compare=False, default=False)
    result: str = field(compare=False, default="")


class FailoverManager:
    """Turns detector events into executed recovery tasks (failover.rs:127-425)."""

    def __init__(
        self,
        shard_manager: ShardManager,
        healthy_nodes_fn: Callable[[], List[str]],
        replica_count: int = 3,
    ):
        self.shards = shard_manager
        self.healthy_nodes_fn = healthy_nodes_fn
        self.replica_count = replica_count
        self._lock = threading.Lock()
        self._queue: List[RecoveryTask] = []
        self.completed: List[RecoveryTask] = []

    # -- event intake ------------------------------------------------------------

    def on_node_state_change(self, node_id: str, state: NodeState) -> None:
        if state == NodeState.FAILED:
            self.enqueue_failure(node_id)

    def enqueue_failure(self, node_id: str) -> None:
        now = time.time()
        with self._lock:
            for sid in self.shards.map.shards_on_node(node_id, primary_only=True):
                heapq.heappush(self._queue, RecoveryTask(
                    priority=0, created_at=now,
                    kind=RecoveryKind.PRIMARY_FAILOVER, node_id=node_id, shard_id=sid,
                ))
            for sid in self.shards.map.shards_on_node(node_id):
                heapq.heappush(self._queue, RecoveryTask(
                    priority=1, created_at=now,
                    kind=RecoveryKind.REPLICA_REPLACEMENT, node_id=node_id, shard_id=sid,
                ))

    def enqueue_tasks(self, tasks: List[RecoveryTask]) -> None:
        with self._lock:
            for t in tasks:
                heapq.heappush(self._queue, t)

    # -- deterministic placement repair (raft apply path) --------------------------

    def apply_placement_for_failure(
        self, node_id: str, healthy: List[str]
    ) -> List[RecoveryTask]:
        """Placement-only failure repair, safe to run inside the raft apply
        path on EVERY node: promote a replica over each failed primary and top
        replica lists back up from the replicated-healthy member set. Pure
        function of replicated state (``healthy`` must come from the raft-
        applied member states, pre-sorted) — no RPCs, no data movement — so
        all appliers converge on the same map.

        Returns the DATA_RESYNC tasks (one per shard that gained replicas,
        targeted at exactly the added nodes) for a leader-side background
        worker to execute OUTSIDE the apply path; the reference ran its whole
        RecoveryCoordinator inline (failover.rs:801-1249, largely stubs),
        which on a real cluster would stall every subsequent apply."""
        now = time.time()
        resync: List[RecoveryTask] = []
        # Capture the affected shard set BEFORE mutating: promotion removes
        # the failed node from the shard entirely, so a second
        # shards_on_node() pass would skip every shard it was primary for and
        # never top its replicas back up (permanent under-replication).
        affected = self.shards.map.shards_on_node(node_id)
        for sid in self.shards.map.shards_on_node(node_id, primary_only=True):
            if self.shards.map.promote_replica(sid, node_id) is None:
                # No replica to promote (shard was primary-only): leaving the
                # dead node as primary would route every write and every
                # resync pull at it forever. Elect a deterministic new
                # (empty) primary so the shard accepts writes again; its
                # pre-failure data is recoverable only if the node rejoins.
                info = self.shards.map.shards[sid]
                fallback = sorted(n for n in healthy if n != node_id)
                if fallback:
                    info.primary_node = fallback[0]
                    info.state = ShardState.ACTIVE
                    info.version += 1
        for sid in affected:
            info = self.shards.map.shards[sid]
            if node_id in info.replica_nodes:
                info.replica_nodes.remove(node_id)
            current = set(info.all_nodes())
            candidates = sorted(
                n for n in healthy if n not in current and n != node_id
            )
            want = self.replica_count - len(info.all_nodes())
            added = candidates[: max(0, want)]
            if added:
                info.replica_nodes.extend(added)
                info.version += 1
                resync.append(RecoveryTask(
                    priority=1, created_at=now, kind=RecoveryKind.DATA_RESYNC,
                    node_id=node_id, shard_id=sid, targets=list(added),
                ))
        return resync

    # -- execution -----------------------------------------------------------------

    def run_pending(self, max_tasks: int = 100) -> List[RecoveryTask]:
        """Drain the priority queue (failover.rs RecoveryCoordinator)."""
        done: List[RecoveryTask] = []
        for _ in range(max_tasks):
            with self._lock:
                if not self._queue:
                    break
                task = heapq.heappop(self._queue)
            try:
                self._execute(task)
            except Exception as e:
                # A recovery step against an unreachable node must not abort
                # the caller (these run inside the raft apply path); record the
                # error — the next failure/reconcile cycle retries placement.
                task.result = f"error:{type(e).__name__}"
                task.done = True
            with self._lock:
                self.completed.append(task)
            done.append(task)
        return done

    def _execute(self, task: RecoveryTask) -> None:
        healthy = [n for n in self.healthy_nodes_fn() if n != task.node_id]
        info = self.shards.map.shards[task.shard_id]
        if task.kind == RecoveryKind.PRIMARY_FAILOVER:
            if info.primary_node != task.node_id:
                task.result = "already-failed-over"
            else:
                new_primary = self.shards.map.promote_replica(task.shard_id, task.node_id)
                task.result = f"promoted:{new_primary}" if new_primary else "no-replica"
        elif task.kind == RecoveryKind.REPLICA_REPLACEMENT:
            if task.node_id in info.replica_nodes:
                info.replica_nodes.remove(task.node_id)
            current = set(info.all_nodes())
            candidates = [n for n in healthy if n not in current]
            want = self.replica_count - len(info.all_nodes())
            added = []
            for n in candidates[:max(0, want)]:
                info.replica_nodes.append(n)
                added.append(n)
            if added:
                # resync the new replicas from a live owner
                docs = self._pull_from_live_owner(task.shard_id, healthy, added)
                for n in added:
                    self.shards.data.push_docs(n, docs)
                task.result = f"added:{','.join(added)}"
            else:
                task.result = "no-candidate"
        elif task.kind == RecoveryKind.DATA_RESYNC:
            targets = task.targets or info.replica_nodes
            docs = self._pull_from_live_owner(task.shard_id, healthy, targets)
            for n in targets:
                self.shards.data.push_docs(n, docs)
            task.result = f"resynced:{len(docs)}"
        elif task.kind == RecoveryKind.SHARD_REALLOCATION:
            moves = self.shards.plan_rebalance(healthy)
            for sid, dst in moves:
                self.shards.migrate_shard(sid, dst)
            task.result = f"moves:{len(moves)}"
        task.done = True

    def _pull_from_live_owner(self, shard_id: int, healthy: List[str],
                              targets: List[str]) -> List[Any]:
        """Pull a shard's documents from a HEALTHY current owner (primary
        preferred), skipping the resync targets themselves — the recorded
        primary may be the dead node this recovery is cleaning up after, and
        pulling from it would fail every cycle. No live owner with data (a
        primary-only shard whose node died) resolves to an empty pull: the
        shard restarts empty rather than wedging recovery forever."""
        info = self.shards.map.shards[shard_id]
        sources = [
            n for n in [info.primary_node, *info.replica_nodes]
            if n and n in healthy and n not in targets
        ]
        last_err: Optional[Exception] = None
        for src in sources:
            try:
                return self.shards.data.pull_shard(src, shard_id)
            except Exception as e:  # unreachable owner — try the next
                last_err = e
        if last_err is not None:
            raise last_err
        return []

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

"""Replication policies (reference src/distributed/replication.rs).

Per-shard ReplicaGroup {primary, replicas, sync_state, version}
(replication.rs:39-51) with all three confirmation rules actually implemented
(replication.rs:219-345):

- synchronous: every replica must ack before the write returns
- asynchronous: primary ack only; replicas written on a background pool
- quorum: return once ceil((n+1)/2) copies (incl. primary) acked

Replica health monitoring keeps a latency history per replica
(replication.rs:54-101, 500-539); the consistency check requires >=99% of
tracked writes confirmed on each replica (replication.rs:464-497).

The write primitive is pluggable: ``write(node_id, docs) -> int``.
"""

from __future__ import annotations

import concurrent.futures
import enum
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from grape_vector_db_tpu_torch.errors import ReplicationError

__all__ = ["SyncPolicy", "ReplicaHealth", "WriteReceipt", "ReplicationManager"]


class SyncPolicy(str, enum.Enum):
    SYNCHRONOUS = "synchronous"
    ASYNCHRONOUS = "asynchronous"
    QUORUM = "quorum"


@dataclass
class ReplicaHealth:
    node_id: str
    healthy: bool = True
    latencies_ms: Deque[float] = field(default_factory=lambda: deque(maxlen=100))
    writes_attempted: int = 0
    writes_confirmed: int = 0

    @property
    def avg_latency_ms(self) -> float:
        return sum(self.latencies_ms) / len(self.latencies_ms) if self.latencies_ms else 0.0

    @property
    def confirm_rate(self) -> float:
        return (self.writes_confirmed / self.writes_attempted
                if self.writes_attempted else 1.0)


@dataclass
class WriteReceipt:
    acks: int
    total: int
    policy: str
    pending_async: int = 0


class ReplicationManager:
    def __init__(
        self,
        write_fn: Callable[[str, List[Any]], int],
        policy: SyncPolicy = SyncPolicy.QUORUM,
        workers: int = 8,
        replica_timeout_s: float = 2.0,
    ):
        self.write_fn = write_fn
        self.policy = policy
        self.replica_timeout_s = replica_timeout_s
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="gvdb-repl"
        )
        self._lock = threading.Lock()
        self._health: Dict[str, ReplicaHealth] = {}

    def _h(self, node_id: str) -> ReplicaHealth:
        with self._lock:
            if node_id not in self._health:
                self._health[node_id] = ReplicaHealth(node_id)
            return self._health[node_id]

    def _write_one(self, node_id: str, docs: List[Any]) -> bool:
        h = self._h(node_id)
        with self._lock:
            h.writes_attempted += 1
        t0 = time.perf_counter()
        try:
            self.write_fn(node_id, docs)
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                h.writes_confirmed += 1
                h.latencies_ms.append(ms)
                h.healthy = True
            return True
        except Exception:
            with self._lock:
                h.healthy = False
            return False

    def replicate(
        self,
        docs: List[Any],
        primary: str,
        replicas: Sequence[str],
        policy: Optional[SyncPolicy] = None,
    ) -> WriteReceipt:
        """Write to primary + replicas under the policy. Raises ReplicationError
        when the policy's confirmation rule can't be met."""
        policy = policy or self.policy
        if not self._write_one(primary, docs):
            e = ReplicationError(f"primary write failed on {primary}")
            e.stage = "primary"  # nothing landed — safe for callers to retry
            raise e
        total = 1 + len(replicas)

        if policy == SyncPolicy.ASYNCHRONOUS:
            for r in replicas:
                self._pool.submit(self._write_one, r, docs)
            return WriteReceipt(acks=1, total=total, policy=policy.value,
                                pending_async=len(replicas))

        futures = {self._pool.submit(self._write_one, r, docs): r for r in replicas}
        needed = total if policy == SyncPolicy.SYNCHRONOUS else (total // 2 + 1)
        acks = 1
        try:
            for fut in concurrent.futures.as_completed(
                futures, timeout=self.replica_timeout_s
            ):
                if fut.result():
                    acks += 1
                if acks >= needed:
                    break
        except concurrent.futures.TimeoutError:
            pass
        if acks < needed:
            e = ReplicationError(
                f"{policy.value} replication got {acks}/{needed} acks"
            )
            e.stage = "acks"  # the primary write DID land
            raise e
        return WriteReceipt(acks=acks, total=total, policy=policy.value)

    # -- health / consistency ------------------------------------------------------

    def replica_health(self) -> Dict[str, ReplicaHealth]:
        with self._lock:
            return dict(self._health)

    def consistency_check(self, threshold: float = 0.99) -> Dict[str, bool]:
        """replication.rs:464-497: each replica must have >= threshold of its
        writes confirmed."""
        with self._lock:
            return {nid: h.confirm_rate >= threshold for nid, h in self._health.items()}

    def close(self) -> None:
        self._pool.shutdown(wait=False)

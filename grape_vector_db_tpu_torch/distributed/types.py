"""Distributed-layer schema (reference types.rs:551-856).

NodeId/Term/LogIndex/ShardId newtypes become plain str/int; the structural
types (ClusterConfig, NodeInfo/NodeState/NodeLoad, ShardInfo/ShardState,
ClusterHealth/Stats, HeartbeatMessage) carry the same fields and defaults
(shard_count=16, replica_count=3, consistency levels Strong/Eventual/Session —
types.rs:551-587).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "ConsistencyLevel",
    "ClusterConfig",
    "NodeState",
    "NodeLoad",
    "NodeInfo",
    "ShardState",
    "ShardInfo",
    "ClusterHealth",
    "ClusterStats",
    "HeartbeatMessage",
    "SessionToken",
]


class ConsistencyLevel(str, enum.Enum):
    STRONG = "strong"
    EVENTUAL = "eventual"
    SESSION = "session"


@dataclass
class SessionToken:
    """Read-your-writes token for SESSION consistency (types.rs
    ConsistencyLevel::Session intent — the reference maps it to quorum writes
    and stops there; here the token carries per-shard versions so reads can
    actually enforce it).

    Each replica bumps a per-shard version counter when it applies a write;
    an upsert records the primary's post-write versions into the caller's
    token, and a search carrying the token routes those shards to replicas
    that have caught up (waiting briefly for lagging ones)."""

    versions: Dict[int, int] = field(default_factory=dict)

    def observe(self, shard_id: int, version: int) -> None:
        if version > self.versions.get(shard_id, 0):
            self.versions[shard_id] = version

    def merge(self, other: "SessionToken") -> None:
        for sid, v in other.versions.items():
            self.observe(sid, v)

    def to_dict(self) -> Dict[str, int]:
        return {str(sid): v for sid, v in self.versions.items()}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "SessionToken":
        return SessionToken(versions={int(k): v for k, v in d.items()})


@dataclass
class ClusterConfig:
    """types.rs:551-587 ClusterConfig."""

    cluster_id: str = "grape-cluster"
    shard_count: int = 16
    replica_count: int = 3
    consistency: ConsistencyLevel = ConsistencyLevel.EVENTUAL
    node_timeout_s: float = 10.0
    heartbeat_interval_s: float = 2.0
    election_timeout_ms: tuple = (150, 300)
    raft_heartbeat_ms: float = 50.0
    virtual_nodes_per_node: int = 100
    rebalance_threshold: float = 0.2  # ±20% (shard.rs:1250-1419)
    # Multi-raft: number of independent data raft groups carrying STRONG
    # writes (0 = single group shared with metadata). Shards map to groups by
    # shard_id % data_raft_groups; leaders spread across nodes, so write
    # throughput scales past one leader's pipeline.
    data_raft_groups: int = 0


class NodeState(str, enum.Enum):
    HEALTHY = "healthy"
    SUSPECTED = "suspected"
    FAILED = "failed"
    RECOVERING = "recovering"
    OFFLINE = "offline"
    JOINING = "joining"
    LEAVING = "leaving"


@dataclass
class NodeLoad:
    cpu: float = 0.0
    memory: float = 0.0
    disk: float = 0.0
    qps: float = 0.0
    active_connections: int = 0
    avg_response_time_ms: float = 0.0


@dataclass
class NodeInfo:
    node_id: str
    address: str
    state: NodeState = NodeState.HEALTHY
    load: NodeLoad = field(default_factory=NodeLoad)
    weight: float = 1.0
    datacenter: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    joined_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "node_id": self.node_id,
            "address": self.address,
            "state": self.state.value,
            "weight": self.weight,
            "datacenter": self.datacenter,
            "labels": dict(self.labels),
        }


class ShardState(str, enum.Enum):
    ACTIVE = "active"
    MIGRATING = "migrating"
    REBUILDING = "rebuilding"
    OFFLINE = "offline"


@dataclass
class ShardInfo:
    shard_id: int
    primary_node: str
    replica_nodes: List[str] = field(default_factory=list)
    state: ShardState = ShardState.ACTIVE
    range_start: int = 0
    range_end: int = 0
    point_count: int = 0
    version: int = 0

    def all_nodes(self) -> List[str]:
        return [self.primary_node] + list(self.replica_nodes)


@dataclass
class ClusterHealth:
    status: str = "healthy"  # healthy | degraded | critical
    total_nodes: int = 0
    healthy_nodes: int = 0
    total_shards: int = 0
    active_shards: int = 0
    under_replicated_shards: int = 0


@dataclass
class ClusterStats:
    total_documents: int = 0
    total_nodes: int = 0
    total_shards: int = 0
    qps: float = 0.0
    avg_latency_ms: float = 0.0
    per_node: Dict[str, Dict[str, float]] = field(default_factory=dict)


@dataclass
class HeartbeatMessage:
    node_id: str
    term: int = 0
    load: NodeLoad = field(default_factory=NodeLoad)
    timestamp: float = field(default_factory=time.time)

"""Shard routing + migration (reference src/distributed/shard.rs, 1917 LoC).

- Hash-range shard map: the 64-bit hash space is divided into
  ``shard_count`` equal ranges (shard.rs:75-99, 424-475). Default hash is
  xxhash64 of the doc id.
- Hash algorithms (shard.rs:101-110): simple (hash % count), range
  (hash-range lookup), consistent (ring lookup).
- ConsistentHashRing with weighted virtual nodes (100/node default), binary
  search lookup, and a routing cache (shard.rs:164-372).
- Migration pipeline (shard.rs:925-1674): mark MIGRATING -> collect from source
  -> copy to target -> verify integrity (count + content hash) -> remap ->
  cleanup. Data access is pluggable so the same pipeline drives in-process
  tests and gRPC nodes — the reference's version bottomed out in a
  MockGrpcClient (shard.rs:1872-1917); this one moves real documents.
- Rebalancing by per-node shard-count deviation, ±20% threshold
  (shard.rs:1250-1419).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from grape_vector_db_tpu_torch.utils.xxh64 import xxh64_intdigest

from grape_vector_db_tpu_torch.distributed.types import ShardInfo, ShardState
from grape_vector_db_tpu_torch.errors import ShardError

__all__ = [
    "hash_key",
    "ConsistentHashRing",
    "ShardMap",
    "ShardDataAccess",
    "MigrationReport",
    "ShardManager",
]

_U64 = 2**64


def hash_key(key: str) -> int:
    return xxh64_intdigest(key)


class ConsistentHashRing:
    """Weighted virtual-node ring (shard.rs:164-372)."""

    def __init__(self, virtual_nodes: int = 100, cache_size: int = 10_000):
        self.virtual_nodes = virtual_nodes
        self._lock = threading.Lock()
        self._points: List[int] = []
        self._owners: List[str] = []
        self._weights: Dict[str, float] = {}
        self._cache: Dict[int, str] = {}
        self._cache_size = cache_size

    def add_node(self, node_id: str, weight: float = 1.0) -> None:
        with self._lock:
            self._weights[node_id] = weight
            self._rebuild()

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._weights.pop(node_id, None)
            self._rebuild()

    def _rebuild(self) -> None:
        pts: List[Tuple[int, str]] = []
        for node, w in self._weights.items():
            count = max(1, int(self.virtual_nodes * w))
            for i in range(count):
                pts.append((hash_key(f"{node}#vn{i}"), node))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [o for _, o in pts]
        self._cache.clear()

    def node_for(self, key: str) -> Optional[str]:
        h = hash_key(key)
        with self._lock:
            if not self._points:
                return None
            hit = self._cache.get(h)
            if hit is not None and hit in self._weights:
                return hit
            i = bisect.bisect_left(self._points, h) % len(self._points)
            owner = self._owners[i]
            if len(self._cache) < self._cache_size:
                self._cache[h] = owner
            return owner

    def nodes(self) -> List[str]:
        with self._lock:
            return list(self._weights)


class ShardMap:
    """shard_id assignment over the hash space + shard -> nodes placement."""

    def __init__(self, shard_count: int = 16, replica_count: int = 3,
                 algorithm: str = "range"):
        if algorithm not in ("simple", "range", "consistent"):
            raise ShardError(f"unknown hash algorithm {algorithm}")
        self.shard_count = shard_count
        self.replica_count = replica_count
        self.algorithm = algorithm
        self._ring = ConsistentHashRing()
        self._lock = threading.RLock()
        self.shards: Dict[int, ShardInfo] = {}
        size = _U64 // shard_count
        for sid in range(shard_count):
            self.shards[sid] = ShardInfo(
                shard_id=sid, primary_node="",
                range_start=sid * size,
                range_end=(sid + 1) * size - 1 if sid < shard_count - 1 else _U64 - 1,
            )

    # -- key -> shard ------------------------------------------------------------

    def shard_for_key(self, key: str) -> int:
        h = hash_key(key)
        if self.algorithm == "simple":
            return h % self.shard_count
        # range (and consistent for the shard step — ring is for node placement)
        return min(h // (_U64 // self.shard_count), self.shard_count - 1)

    # -- shard -> nodes --------------------------------------------------------------

    def assign_all(self, node_ids: Sequence[str]) -> None:
        """(Re)assign primaries + replicas round-robin over the node list."""
        with self._lock:
            nodes = list(node_ids)
            if not nodes:
                return
            for nid in nodes:
                self._ring.add_node(nid)
            for sid, info in self.shards.items():
                owners = [nodes[(sid + r) % len(nodes)]
                          for r in range(min(self.replica_count, len(nodes)))]
                info.primary_node = owners[0]
                info.replica_nodes = owners[1:]
                info.version += 1

    def nodes_for_key(self, key: str) -> ShardInfo:
        with self._lock:
            return self.shards[self.shard_for_key(key)]

    def shards_on_node(self, node_id: str, primary_only: bool = False) -> List[int]:
        with self._lock:
            out = []
            for sid, info in self.shards.items():
                if info.primary_node == node_id or (
                    not primary_only and node_id in info.replica_nodes
                ):
                    out.append(sid)
            return out

    def promote_replica(self, shard_id: int, failed_node: str) -> Optional[str]:
        """Primary failover: first healthy replica becomes primary
        (cluster.rs:501-591 semantics)."""
        with self._lock:
            info = self.shards[shard_id]
            if info.primary_node != failed_node:
                return info.primary_node
            if not info.replica_nodes:
                info.state = ShardState.OFFLINE
                return None
            new_primary = info.replica_nodes.pop(0)
            info.primary_node = new_primary
            info.version += 1
            return new_primary

    def remove_node(self, node_id: str) -> List[int]:
        """Drop a node from all placements; returns shards that lost a copy."""
        affected = []
        with self._lock:
            self._ring.remove_node(node_id)
            for sid, info in self.shards.items():
                if info.primary_node == node_id or node_id in info.replica_nodes:
                    affected.append(sid)
                    if node_id in info.replica_nodes:
                        info.replica_nodes.remove(node_id)
                    if info.primary_node == node_id:
                        self.promote_replica(sid, node_id)
        return affected

    def set_placement(self, shard_id: int, primary: str, replicas: List[str]) -> None:
        with self._lock:
            info = self.shards[shard_id]
            info.primary_node = primary
            info.replica_nodes = list(replicas)
            info.version += 1

    def snapshot(self) -> Dict[int, ShardInfo]:
        with self._lock:
            return {
                sid: ShardInfo(
                    shard_id=i.shard_id, primary_node=i.primary_node,
                    replica_nodes=list(i.replica_nodes), state=i.state,
                    range_start=i.range_start, range_end=i.range_end,
                    point_count=i.point_count, version=i.version,
                )
                for sid, i in self.shards.items()
            }


class ShardDataAccess:
    """What migration needs from a node (implemented by ClusterNode / client)."""

    def count_shard(self, node_id: str, shard_id: int) -> int:
        raise NotImplementedError

    def pull_shard(self, node_id: str, shard_id: int) -> List[Dict[str, Any]]:
        """Returns serialized DocumentRecords for the shard."""
        raise NotImplementedError

    def push_docs(self, node_id: str, docs: List[Dict[str, Any]]) -> int:
        raise NotImplementedError

    def drop_shard(self, node_id: str, shard_id: int) -> int:
        raise NotImplementedError


@dataclass
class MigrationReport:
    shard_id: int
    from_node: str
    to_node: str
    docs_moved: int
    verified: bool
    dropped_at_source: int


class ShardManager:
    """Shard placement + migration + rebalancing over a ShardMap."""

    def __init__(self, shard_map: ShardMap, data: ShardDataAccess,
                 rebalance_threshold: float = 0.2):
        self.map = shard_map
        self.data = data
        self.rebalance_threshold = rebalance_threshold
        self._lock = threading.Lock()
        self.migrations: List[MigrationReport] = []

    @staticmethod
    def _content_hash(docs: List[Dict[str, Any]]) -> str:
        h = hashlib.sha256()
        for d in sorted(docs, key=lambda x: x["id"]):
            h.update(d["id"].encode())
            h.update(str(d.get("updated_at", "")).encode())
        return h.hexdigest()

    def migrate_shard(self, shard_id: int, to_node: str) -> MigrationReport:
        """mark -> collect -> copy -> verify -> remap -> cleanup (shard.rs:925-1674)."""
        with self._lock:
            info = self.map.shards[shard_id]
            from_node = info.primary_node
            if from_node == to_node:
                raise ShardError(f"shard {shard_id} already on {to_node}")
            info.state = ShardState.MIGRATING
        try:
            docs = self.data.pull_shard(from_node, shard_id)
            src_hash = self._content_hash(docs)
            pushed = self.data.push_docs(to_node, docs)
            # verify: count + content hash on the target
            tgt_docs = self.data.pull_shard(to_node, shard_id)
            verified = (
                pushed == len(docs)
                and len(tgt_docs) >= len(docs)
                and self._content_hash(
                    [d for d in tgt_docs if d["id"] in {x["id"] for x in docs}]
                ) == src_hash
            )
            if not verified:
                raise ShardError(
                    f"migration verify failed for shard {shard_id}: "
                    f"pushed={pushed} expected={len(docs)}"
                )
            replicas = [n for n in self.map.shards[shard_id].replica_nodes
                        if n != to_node]
            self.map.set_placement(shard_id, to_node, replicas)
            dropped = self.data.drop_shard(from_node, shard_id)
            report = MigrationReport(
                shard_id=shard_id, from_node=from_node, to_node=to_node,
                docs_moved=len(docs), verified=True, dropped_at_source=dropped,
            )
            with self._lock:
                self.map.shards[shard_id].state = ShardState.ACTIVE
                self.migrations.append(report)
            return report
        except Exception:
            with self._lock:
                self.map.shards[shard_id].state = ShardState.ACTIVE
            raise

    # -- rebalancing (shard.rs:1250-1419) -------------------------------------------

    def plan_rebalance(self, node_ids: Sequence[str]) -> List[Tuple[int, str]]:
        """Returns [(shard_id, to_node)] moves to equalize primary counts."""
        nodes = list(node_ids)
        if not nodes:
            return []
        counts = {n: len(self.map.shards_on_node(n, primary_only=True)) for n in nodes}
        ideal = self.map.shard_count / len(nodes)
        moves: List[Tuple[int, str]] = []
        over = [n for n in nodes if counts[n] > ideal * (1 + self.rebalance_threshold)]
        for src in over:
            sids = self.map.shards_on_node(src, primary_only=True)
            while counts[src] - 1 >= ideal and sids:
                dst = min(nodes, key=lambda n: counts[n])
                if counts[dst] + 1 > ideal * (1 + self.rebalance_threshold):
                    break
                sid = sids.pop()
                moves.append((sid, dst))
                counts[src] -= 1
                counts[dst] += 1
        return moves

    def rebalance(self, node_ids: Sequence[str]) -> List[MigrationReport]:
        return [self.migrate_shard(sid, dst) for sid, dst in self.plan_rebalance(node_ids)]

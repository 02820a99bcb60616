"""Intelligent load balancer (reference src/distributed/load_balancer.rs).

Strategies (load_balancer.rs:34-46): round_robin, weighted_round_robin,
least_connections, load_based (score = 0.5*weight + 0.3*connections +
0.2*latency, load_balancer.rs:398-430), location_aware (datacenter latency-tier
grouping). Response-time-driven weight update ``clamp(1000/(rt+100), 0.1..1.0)``
(load_balancer.rs:250-287); balance report with 15% deviation threshold
(load_balancer.rs:494-528); staleness sweeper (load_balancer.rs:531-571).
"""

from __future__ import annotations

import random
import threading
import time
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from grape_vector_db_tpu_torch.distributed.types import NodeInfo, NodeState
from grape_vector_db_tpu_torch.errors import ConfigError, UnavailableError

__all__ = ["LoadBalancerConfig", "BalanceReport", "IntelligentLoadBalancer"]


@dataclass
class LoadBalancerConfig:
    strategy: str = "round_robin"  # round_robin | weighted_round_robin |
    # least_connections | load_based | location_aware
    local_datacenter: str = "default"
    stale_after_s: float = 60.0
    deviation_threshold: float = 0.15

    def validate(self) -> None:
        ok = {"round_robin", "weighted_round_robin", "least_connections",
              "load_based", "location_aware"}
        if self.strategy not in ok:
            raise ConfigError(f"unknown LB strategy {self.strategy!r}; one of {sorted(ok)}")


@dataclass
class _NodeStats:
    info: NodeInfo
    weight: float = 1.0
    active_connections: int = 0
    total_requests: int = 0
    avg_response_ms: float = 0.0
    last_seen: float = field(default_factory=time.monotonic)


@dataclass
class BalanceReport:
    balanced: bool
    per_node_share: Dict[str, float]
    max_deviation: float


class IntelligentLoadBalancer:
    def __init__(self, config: Optional[LoadBalancerConfig] = None):
        self.config = config or LoadBalancerConfig()
        self.config.validate()
        self._lock = threading.Lock()
        self._nodes: Dict[str, _NodeStats] = {}
        self._rr = 0

    # -- membership ------------------------------------------------------------

    def add_node(self, info: NodeInfo) -> None:
        # The LB owns a COPY of the NodeInfo: its staleness sweep
        # (sweep_stale -> SUSPECTED) is a local routing hint, while the
        # caller's object is typically the raft-replicated membership entry —
        # sharing the object let the LB's view silently corrupt the
        # replicated one (a node never heartbeats ITSELF, so every node's
        # own entry went stale-SUSPECTED once uptime passed stale_after_s,
        # and cluster_health reported a permanently degraded cluster).
        # Membership transitions still reach the LB explicitly via
        # set_node_state (the node_failed/node_recovered apply path).
        with self._lock:
            self._nodes[info.node_id] = _NodeStats(
                info=dataclasses.replace(info), weight=info.weight)

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def node_ids(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def mark_heartbeat(self, node_id: str) -> None:
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id].last_seen = time.monotonic()

    # -- routing -----------------------------------------------------------------

    def _healthy(self) -> List[_NodeStats]:
        return [
            s for s in self._nodes.values()
            if s.info.state in (NodeState.HEALTHY, NodeState.RECOVERING)
        ]

    def route_request(self, backups: int = 2) -> List[str]:
        """Pick a target + up to `backups` fallbacks (request_router.rs usage)."""
        with self._lock:
            healthy = self._healthy()
            if not healthy:
                raise UnavailableError("no healthy nodes")
            strategy = self.config.strategy
            if strategy == "round_robin":
                order = sorted(healthy, key=lambda s: s.info.node_id)
                start = self._rr % len(order)
                self._rr += 1
                picked = order[start:] + order[:start]
            elif strategy == "weighted_round_robin":
                picked = self._weighted_sample(healthy)
            elif strategy == "least_connections":
                picked = sorted(healthy, key=lambda s: s.active_connections)
            elif strategy == "load_based":
                picked = sorted(healthy, key=self._load_score, reverse=True)
            else:  # location_aware
                local = [s for s in healthy
                         if s.info.datacenter == self.config.local_datacenter]
                remote = [s for s in healthy
                          if s.info.datacenter != self.config.local_datacenter]
                picked = (sorted(local, key=self._load_score, reverse=True)
                          + sorted(remote, key=self._load_score, reverse=True))
            return [s.info.node_id for s in picked[: backups + 1]]

    @staticmethod
    def _weighted_sample(healthy: List[_NodeStats]) -> List[_NodeStats]:
        pool = list(healthy)
        out: List[_NodeStats] = []
        while pool:
            total = sum(s.weight for s in pool)
            r = random.uniform(0, total)
            acc = 0.0
            for s in pool:
                acc += s.weight
                if r <= acc:
                    out.append(s)
                    pool.remove(s)
                    break
        return out

    @staticmethod
    def _load_score(s: _NodeStats) -> float:
        """load_balancer.rs:398-430: higher is better."""
        conn_score = 1.0 / (1.0 + s.active_connections)
        lat_score = 1.0 / (1.0 + s.avg_response_ms / 100.0)
        return 0.5 * s.weight + 0.3 * conn_score + 0.2 * lat_score

    # -- feedback ------------------------------------------------------------------

    def on_request_start(self, node_id: str) -> None:
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id].active_connections += 1

    def on_request_end(self, node_id: str, response_ms: float, success: bool) -> None:
        with self._lock:
            s = self._nodes.get(node_id)
            if s is None:
                return
            s.active_connections = max(0, s.active_connections - 1)
            s.total_requests += 1
            alpha = 0.2
            s.avg_response_ms = (1 - alpha) * s.avg_response_ms + alpha * response_ms
            # clamp(1000/(rt+100), 0.1..1.0) (load_balancer.rs:250-287)
            s.weight = max(0.1, min(1.0, 1000.0 / (s.avg_response_ms + 100.0)))
            if not success:
                s.weight = max(0.1, s.weight * 0.5)
            s.last_seen = time.monotonic()

    def set_node_state(self, node_id: str, state: NodeState) -> None:
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id].info.state = state

    # -- reporting / maintenance -----------------------------------------------------

    def balance_report(self) -> BalanceReport:
        with self._lock:
            total = sum(s.total_requests for s in self._nodes.values())
            if total == 0 or not self._nodes:
                return BalanceReport(True, {}, 0.0)
            share = {nid: s.total_requests / total for nid, s in self._nodes.items()}
            ideal = 1.0 / len(self._nodes)
            max_dev = max(abs(v - ideal) for v in share.values())
            return BalanceReport(
                balanced=max_dev <= self.config.deviation_threshold,
                per_node_share=share,
                max_deviation=max_dev,
            )

    def sweep_stale(self) -> List[str]:
        """Mark nodes unseen for stale_after_s as SUSPECTED (load_balancer.rs:531-571)."""
        now = time.monotonic()
        stale = []
        with self._lock:
            for nid, s in self._nodes.items():
                if (now - s.last_seen > self.config.stale_after_s
                        and s.info.state == NodeState.HEALTHY):
                    s.info.state = NodeState.SUSPECTED
                    stale.append(nid)
        return stale

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                nid: {
                    "weight": s.weight,
                    "active_connections": float(s.active_connections),
                    "total_requests": float(s.total_requests),
                    "avg_response_ms": s.avg_response_ms,
                }
                for nid, s in self._nodes.items()
            }

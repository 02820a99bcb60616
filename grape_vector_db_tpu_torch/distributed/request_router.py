"""Cluster-aware request router (reference src/distributed/request_router.rs).

Routes each request via the load balancer, tries the target then up to 2
backups with per-attempt timeout, feeds health back into the LB
(request_router.rs:409-500), keeps typed TTL response caches
(request_router.rs:156-205), and tracks RoutingMetrics
(request_router.rs:207-226).

The actual send is a pluggable callable ``send(node_id, request) -> response``
so the same router serves the in-process transport, gRPC, or REST.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from grape_vector_db_tpu_torch.distributed.load_balancer import IntelligentLoadBalancer
from grape_vector_db_tpu_torch.engine.cache import TtlCache
from grape_vector_db_tpu_torch.errors import UnavailableError

__all__ = ["RoutingMetrics", "RouterConfig", "ClusterAwareRequestRouter"]


@dataclass
class RouterConfig:
    max_backups: int = 2
    attempt_timeout_s: float = 2.0
    cache_search_responses: bool = True
    search_cache_size: int = 4096
    search_cache_ttl_s: float = 30.0


@dataclass
class RoutingMetrics:
    total: int = 0
    success: int = 0
    failed: int = 0
    failovers: int = 0
    cache_hits: int = 0
    per_node: Dict[str, int] = field(default_factory=dict)


class ClusterAwareRequestRouter:
    def __init__(
        self,
        load_balancer: IntelligentLoadBalancer,
        send: Callable[[str, Any], Any],
        config: Optional[RouterConfig] = None,
    ):
        self.lb = load_balancer
        self.send = send
        self.config = config or RouterConfig()
        self.metrics = RoutingMetrics()
        self._mlock = threading.Lock()
        self._search_cache: TtlCache = TtlCache(
            self.config.search_cache_size, self.config.search_cache_ttl_s
        )

    def execute(self, request: Any, cache_key: Optional[Any] = None) -> Any:
        """Route with failover. ``cache_key`` enables the response cache."""
        if cache_key is not None and self.config.cache_search_responses:
            hit = self._search_cache.get(cache_key)
            if hit is not None:
                with self._mlock:
                    self.metrics.cache_hits += 1
                    self.metrics.total += 1
                    self.metrics.success += 1
                return hit
        candidates = self.lb.route_request(backups=self.config.max_backups)
        last_err: Optional[Exception] = None
        for attempt, node_id in enumerate(candidates):
            self.lb.on_request_start(node_id)
            t0 = time.perf_counter()
            try:
                resp = self.send(node_id, request)
                ms = (time.perf_counter() - t0) * 1e3
                self.lb.on_request_end(node_id, ms, success=True)
                with self._mlock:
                    self.metrics.total += 1
                    self.metrics.success += 1
                    if attempt > 0:
                        self.metrics.failovers += 1
                    self.metrics.per_node[node_id] = (
                        self.metrics.per_node.get(node_id, 0) + 1
                    )
                if cache_key is not None and self.config.cache_search_responses:
                    self._search_cache.put(cache_key, resp)
                return resp
            except Exception as e:
                ms = (time.perf_counter() - t0) * 1e3
                self.lb.on_request_end(node_id, ms, success=False)
                last_err = e
        with self._mlock:
            self.metrics.total += 1
            self.metrics.failed += 1
        raise UnavailableError(f"all routing candidates failed: {last_err}")

    def invalidate_cache(self) -> None:
        self._search_cache.invalidate_all()

    def get_metrics(self) -> RoutingMetrics:
        with self._mlock:
            return RoutingMetrics(
                total=self.metrics.total,
                success=self.metrics.success,
                failed=self.metrics.failed,
                failovers=self.metrics.failovers,
                cache_hits=self.metrics.cache_hits,
                per_node=dict(self.metrics.per_node),
            )

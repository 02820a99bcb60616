"""Pluggable node-to-node transport with built-in fault injection.

The reference tested distributed behavior with an in-process NetworkSimulator
(tests/test_framework.disabled/network.rs:10-180: partitions as node-sets,
per-pair latency, per-node packet loss). Here the simulator IS the in-process
transport, so the same Raft/cluster code runs unchanged in tests (injected
faults) and production (gRPC binding in server/grpc_server.py + cluster_service).

API: a node registers handlers by method name; `call(src, dst, method, payload)`
routes a dict payload and returns a dict response. TransportError models a
drop/partition/timeout.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Set, Tuple

from grape_vector_db_tpu_torch.errors import NetworkError

__all__ = ["TransportError", "Transport", "InProcessTransport", "NetworkSimulator"]


class TransportError(NetworkError):
    pass


class Transport:
    def register(self, node_id: str, handler: Callable[[str, Dict[str, Any]], Dict[str, Any]]) -> None:
        """handler(method, payload) -> response payload."""
        raise NotImplementedError

    def unregister(self, node_id: str) -> None:
        raise NotImplementedError

    def call(self, src: str, dst: str, method: str, payload: Dict[str, Any],
             timeout_s: float = 1.0) -> Dict[str, Any]:
        raise NotImplementedError


class NetworkSimulator:
    """Partition / latency / loss injection (network.rs:100-169 semantics)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._partitions: list[Set[str]] = []
        self._down: Set[str] = set()
        self._loss: Dict[str, float] = {}
        self._latency: Dict[Tuple[str, str], float] = {}
        self._default_latency_s = 0.0

    # -- faults --------------------------------------------------------------

    def create_partition(self, *groups: Set[str]) -> None:
        with self._lock:
            self._partitions = [set(g) for g in groups]

    def heal_partition(self) -> None:
        with self._lock:
            self._partitions = []

    def fail_node(self, node_id: str) -> None:
        with self._lock:
            self._down.add(node_id)

    def recover_node(self, node_id: str) -> None:
        with self._lock:
            self._down.discard(node_id)

    def set_packet_loss(self, node_id: str, probability: float) -> None:
        with self._lock:
            self._loss[node_id] = probability

    def set_latency(self, src: str, dst: str, seconds: float) -> None:
        with self._lock:
            self._latency[(src, dst)] = seconds

    # -- queries ---------------------------------------------------------------

    def can_communicate(self, src: str, dst: str) -> bool:
        with self._lock:
            if src in self._down or dst in self._down:
                return False
            if self._partitions:
                for group in self._partitions:
                    if src in group:
                        return dst in group
                # src not in any declared group: isolated from declared groups
                return not any(dst in g for g in self._partitions)
            return True

    def latency_for(self, src: str, dst: str) -> float:
        with self._lock:
            return self._latency.get((src, dst), self._default_latency_s)

    def should_drop(self, src: str, dst: str) -> bool:
        with self._lock:
            p = max(self._loss.get(src, 0.0), self._loss.get(dst, 0.0))
        return p > 0 and random.random() < p


class InProcessTransport(Transport):
    """All nodes are objects in one process; calls go through the simulator."""

    def __init__(self, simulator: Optional[NetworkSimulator] = None):
        self.sim = simulator or NetworkSimulator()
        self._lock = threading.Lock()
        self._handlers: Dict[str, Callable[[str, Dict[str, Any]], Dict[str, Any]]] = {}

    def register(self, node_id: str, handler) -> None:
        with self._lock:
            self._handlers[node_id] = handler

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._handlers.pop(node_id, None)

    def known_nodes(self) -> Set[str]:
        with self._lock:
            return set(self._handlers)

    def call(self, src: str, dst: str, method: str, payload: Dict[str, Any],
             timeout_s: float = 1.0) -> Dict[str, Any]:
        if not self.sim.can_communicate(src, dst):
            raise TransportError(f"partitioned: {src} -> {dst}")
        if self.sim.should_drop(src, dst):
            raise TransportError(f"packet dropped: {src} -> {dst}")
        lat = self.sim.latency_for(src, dst)
        if lat > 0:
            if lat > timeout_s:
                raise TransportError(f"timeout: {src} -> {dst}")
            time.sleep(lat)
        with self._lock:
            handler = self._handlers.get(dst)
        if handler is None:
            raise TransportError(f"unknown node: {dst}")
        return handler(method, payload)

"""ClusterService — one-stop cluster bootstrap (reference cluster_service.rs).

Boots N ClusterNodes over a shared transport (in-process for tests; the gRPC
binding reuses the same node objects behind server/grpc_server.py handlers),
wires the router + load balancer, runs service discovery (periodic seed-node
health checks that add/remove LB targets, cluster_service.rs:401-472), and
aggregates status.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.distributed.cluster import ClusterNode
from grape_vector_db_tpu_torch.distributed.load_balancer import IntelligentLoadBalancer
from grape_vector_db_tpu_torch.distributed.raft import RaftConfig
from grape_vector_db_tpu_torch.distributed.request_router import ClusterAwareRequestRouter
from grape_vector_db_tpu_torch.distributed.transport import (
    InProcessTransport,
    NetworkSimulator,
    Transport,
)
from grape_vector_db_tpu_torch.distributed.types import ClusterConfig
from grape_vector_db_tpu_torch.errors import ConfigError, UnavailableError
from grape_vector_db_tpu_torch.types import Document

__all__ = ["ClusterService"]


class ClusterService:
    """Boot + operate an in-process cluster (the §4.3 TestCluster made
    production-shaped: the same class drives tests and the embedded-cluster
    deployment mode)."""

    def __init__(
        self,
        node_ids: Sequence[str],
        cluster_config: Optional[ClusterConfig] = None,
        db_config: Optional[VectorDbConfig] = None,
        raft_config: Optional[RaftConfig] = None,
        transport: Optional[Transport] = None,
        simulator: Optional[NetworkSimulator] = None,
        device: str | torch.device = "cuda",
    ):
        # every node keeps its index on ``device``: the card unless the
        # caller asks for the CPU
        if len(node_ids) < 1:
            raise ConfigError("need at least one node")
        self.config = cluster_config or ClusterConfig()
        self.sim = simulator or NetworkSimulator()
        self.transport = transport or InProcessTransport(self.sim)
        self.nodes: Dict[str, ClusterNode] = {}
        self._db_config = db_config
        self._raft_config = raft_config
        self._device = device
        self._stop_discovery = threading.Event()
        self._discovery_thread: Optional[threading.Thread] = None
        for nid in node_ids:
            self.nodes[nid] = ClusterNode(
                node_id=nid,
                address=f"inproc://{nid}",
                seed_nodes=list(node_ids),
                transport=self.transport,
                cluster_config=self.config,
                db_config=db_config,
                raft_config=raft_config,
                device=device,
            )

    # -- lifecycle ----------------------------------------------------------------

    def start(self, join_timeout_s: float = 10.0) -> None:
        for n in self.nodes.values():
            n.start()
        # wait for a raft leader, then register membership
        deadline = time.monotonic() + join_timeout_s
        leader = None
        while time.monotonic() < deadline and leader is None:
            for n in self.nodes.values():
                if n.raft.leader_id is not None:
                    leader = n.raft.leader_id
                    break
            time.sleep(0.02)
        if leader is None:
            raise UnavailableError("no raft leader during cluster start")
        for n in self.nodes.values():
            n.join_cluster()
        # wait until every node sees full membership
        while time.monotonic() < deadline:
            if all(len(n.members) == len(self.nodes) for n in self.nodes.values()):
                break
            time.sleep(0.02)
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, daemon=True, name="gvdb-discovery"
        )
        self._discovery_thread.start()

    def stop(self) -> None:
        self._stop_discovery.set()
        if self._discovery_thread:
            self._discovery_thread.join(timeout=2.0)
        for n in self.nodes.values():
            n.stop()

    def add_node(self, node_id: str, timeout_s: float = 10.0) -> ClusterNode:
        """Boot a brand-new node into the RUNNING cluster (beyond the
        reference's fixed seed set): construct it over the shared transport,
        start it, splice it into every raft group's voter set through the
        live leaders (single-server membership change), and replicate the
        join so shard placements re-spread onto it. The newcomer catches up
        through normal raft backfill/InstallSnapshot, and the ownership-gain
        resync pulls the data of every shard it now owns."""
        if node_id in self.nodes:
            raise ConfigError(f"node {node_id} already exists")
        node = ClusterNode(
            node_id=node_id,
            address=f"inproc://{node_id}",
            seed_nodes=[*self.nodes.keys(), node_id],
            transport=self.transport,
            cluster_config=self.config,
            db_config=self._db_config,
            raft_config=self._raft_config,
            device=self._device,
        )
        node.start()
        # Any node can sponsor, but a dead/partitioned one cannot forward to
        # the leaders — try each in turn (first sponsor may be mid-failure).
        last: Exception = UnavailableError("no sponsor")
        # total budget honored: each sponsor gets an equal slice of what
        # remains, and we stop when the budget is gone
        deadline = time.monotonic() + timeout_s
        sponsors = list(self.nodes.values())
        for i, sponsor in enumerate(sponsors):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            per = max(remaining / (len(sponsors) - i), 1.0)
            try:
                sponsor.add_member(node_id, address=f"inproc://{node_id}",
                                   timeout_s=min(per, remaining))
                self.nodes[node_id] = node
                return node
            except Exception as e:
                last = e
        node.stop()
        raise last

    def remove_node(self, node_id: str, timeout_s: float = 10.0) -> None:
        """Remove a node from the running cluster: voter sets shrink, shards
        re-assign to the survivors, then the node is stopped."""
        if node_id not in self.nodes:
            raise ConfigError(f"unknown node {node_id}")
        last: Exception = UnavailableError("no sponsor")
        deadline = time.monotonic() + timeout_s
        sponsors = [(nid, n) for nid, n in self.nodes.items()
                    if nid != node_id]
        done = False
        for i, (nid, sponsor) in enumerate(sponsors):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            per = max(remaining / (len(sponsors) - i), 1.0)
            try:
                sponsor.remove_member(node_id, timeout_s=min(per, remaining))
                done = True
                break
            except Exception as e:
                last = e
        if not done:
            raise last
        node = self.nodes.pop(node_id)
        node.stop()

    def _discovery_loop(self) -> None:
        """Periodic liveness sweep feeding the per-node LBs
        (cluster_service.rs:401-472)."""
        while not self._stop_discovery.wait(self.config.heartbeat_interval_s):
            for n in self.nodes.values():
                try:
                    # a node is trivially alive to itself, but it never
                    # receives its own heartbeat RPC — touch the self entry
                    # so the staleness sweep only ever suspects PEERS
                    n.load_balancer.mark_heartbeat(n.node_id)
                    n.load_balancer.sweep_stale()
                except Exception:
                    pass

    # -- client facade ---------------------------------------------------------------

    def any_node(self) -> ClusterNode:
        for n in self.nodes.values():
            return n
        raise UnavailableError("no nodes")

    def leader_node(self) -> ClusterNode:
        for n in self.nodes.values():
            if n.raft.leader_id == n.node_id:
                return n
        raise UnavailableError("no leader")

    def upsert(self, docs: Sequence[Document], session=None) -> int:
        return self.any_node().upsert(docs, session=session)

    def search(self, vector, k: int = 10, session=None) -> List[Tuple[str, float]]:
        return self.any_node().search(vector, k, session=session)

    def search_batch(self, vectors, k: int = 10,
                     session=None) -> List[List[Tuple[str, float]]]:
        return self.any_node().search_batch(vectors, k, session=session)

    def delete(self, ids: Sequence[str], session=None) -> int:
        return self.any_node().delete(ids, session=session)

    # -- status -------------------------------------------------------------------------

    def status(self) -> Dict[str, Dict]:
        return {
            nid: {
                "raft": n.raft.status(),
                "health": n.cluster_health().__dict__,
                "docs": n.db.store.count(),
            }
            for nid, n in self.nodes.items()
        }

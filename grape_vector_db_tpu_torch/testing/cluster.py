"""RaftTestCluster — N in-process Raft nodes over a simulated network.

Mirrors the reference's TestCluster surface (test_framework/cluster.rs:41-359):
spawn N nodes, ``wait_for_leader`` with a poll loop, partition/heal by node
sets, majority math, and ``verify_log_consistency`` comparing every node's
applied sequence.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from grape_vector_db_tpu_torch.distributed.raft import RaftConfig, RaftNode, RaftRole
from grape_vector_db_tpu_torch.distributed.transport import InProcessTransport, NetworkSimulator
from grape_vector_db_tpu_torch.storage.store import MemoryDocumentStore

__all__ = ["RaftTestCluster"]


class RaftTestCluster:
    def __init__(self, n: int, config: Optional[RaftConfig] = None,
                 with_storage: bool = True, snapshots: bool = False):
        self.sim = NetworkSimulator()
        self.transport = InProcessTransport(self.sim)
        self.config = config or RaftConfig()
        self.node_ids = [f"node-{i}" for i in range(n)]
        self.applied: Dict[str, List[bytes]] = {nid: [] for nid in self.node_ids}
        self._applied_lock = threading.Lock()
        self.storages = {
            nid: (MemoryDocumentStore() if with_storage else None) for nid in self.node_ids
        }
        self.nodes: Dict[str, RaftNode] = {}
        self.snapshots = snapshots
        for nid in self.node_ids:
            self._make_node(nid)

    def _make_node(self, nid: str) -> RaftNode:
        def apply(entry, nid=nid):
            with self._applied_lock:
                self.applied[nid].append(entry.data)

        def snapshot_fn(nid=nid) -> bytes:
            from grape_vector_db_tpu_torch.storage import msgpack_codec as msgpack

            with self._applied_lock:
                return msgpack.packb(list(self.applied[nid]))

        def restore_fn(data: bytes, nid=nid) -> None:
            from grape_vector_db_tpu_torch.storage import msgpack_codec as msgpack

            with self._applied_lock:
                self.applied[nid] = list(msgpack.unpackb(data, raw=False))

        node = RaftNode(
            nid, list(self.node_ids), self.transport, apply,
            storage=self.storages[nid], config=self.config,
            snapshot_fn=snapshot_fn if self.snapshots else None,
            restore_fn=restore_fn if self.snapshots else None,
        )
        self.nodes[nid] = node
        return node

    def start(self) -> None:
        for n in self.nodes.values():
            n.start()

    def stop(self) -> None:
        for n in self.nodes.values():
            n.stop()

    # -- membership-ish -----------------------------------------------------------

    def kill_node(self, nid: str) -> None:
        """Hard-stop a node (process crash)."""
        self.nodes[nid].stop()

    def add_node(self, nid: str) -> RaftNode:
        """Construct and start a NEW node at runtime. It only becomes a
        voter once the leader replicates an add_voter config entry."""
        self.node_ids.append(nid)
        self.applied[nid] = []
        self.storages[nid] = MemoryDocumentStore()
        node = self._make_node(nid)
        node.start()
        return node

    def restart_node(self, nid: str) -> RaftNode:
        """Restart from its persisted storage (crash recovery)."""
        node = self._make_node(nid)
        node.start()
        return node

    # -- queries ----------------------------------------------------------------------

    def leaders(self, among: Optional[Set[str]] = None) -> List[str]:
        out = []
        for nid, n in self.nodes.items():
            if among is not None and nid not in among:
                continue
            if n.role == RaftRole.LEADER:
                out.append(nid)
        return out

    def wait_for_leader(self, timeout_s: float = 5.0,
                        among: Optional[Set[str]] = None) -> str:
        """Poll until exactly one leader exists among `among` (cluster.rs:138-151)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ls = self.leaders(among)
            if len(ls) == 1:
                return ls[0]
            time.sleep(0.02)
        raise TimeoutError(f"no single leader within {timeout_s}s: {self.leaders(among)}")

    def wait_applied(self, count: int, timeout_s: float = 5.0,
                     among: Optional[Set[str]] = None) -> None:
        deadline = time.monotonic() + timeout_s
        targets = among or set(self.node_ids)
        while time.monotonic() < deadline:
            with self._applied_lock:
                if all(len(self.applied[nid]) >= count for nid in targets):
                    return
            time.sleep(0.02)
        with self._applied_lock:
            state = {nid: len(self.applied[nid]) for nid in targets}
        raise TimeoutError(f"not all nodes applied {count} entries: {state}")

    def verify_log_consistency(self, among: Optional[Set[str]] = None) -> None:
        """All nodes' applied sequences must be prefixes of the longest
        (cluster.rs:258-284)."""
        targets = sorted(among or set(self.node_ids))
        with self._applied_lock:
            seqs = {nid: list(self.applied[nid]) for nid in targets}
        longest = max(seqs.values(), key=len)
        for nid, seq in seqs.items():
            assert seq == longest[: len(seq)], f"{nid} diverged"

    # -- faults --------------------------------------------------------------------------

    def partition(self, *groups: Set[str]) -> None:
        self.sim.create_partition(*groups)

    def heal(self) -> None:
        self.sim.heal_partition()

    def majority(self) -> int:
        return len(self.node_ids) // 2 + 1

"""gRPC <-> cluster-node adapter + GrpcTransport.

Makes the distributed layer run over real gRPC between processes/hosts (DCN):

- ``GrpcClusterAdapter`` translates the 9 cluster/raft/shard RPCs of the proto
  surface into ClusterNode operations, and serves the generic ``Internal`` RPC
  that carries the node-to-node transport (raft + data plane, msgpack payloads)
  — replacing the reference's HTTP/JSON client whose server side was a logging
  stub (network.rs:447-502).
- ``GrpcTransport`` implements the Transport interface over ``Internal``
  (lazy channel per peer, address book), so the exact same ClusterNode code
  runs in-process (tests, embedded cluster) and cross-process (production).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import grpc
import numpy as np
from grape_vector_db_tpu_torch.storage import msgpack_codec as msgpack

from grape_vector_db_tpu_torch.distributed.transport import Transport, TransportError
from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
from grape_vector_db_tpu_torch.server.grpc_server import SERVICE_NAME

__all__ = ["GrpcClusterAdapter", "GrpcTransport"]


def _wire_default(o: Any) -> Any:
    """msgpack's ``default`` hook for the Internal payloads. msgpack refuses
    an ndarray, and a document's vector is one when the device embedder made
    it or a store decoded it, so it goes on the wire as the list of floats
    that a JAX package's peer sends and reads (ROADMAP C.6). Any other type
    is refused as msgpack refuses it."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"can not serialize {type(o).__name__!r} object")


class GrpcClusterAdapter:
    """The `node` object VectorDbServicer delegates its cluster-facing
    handlers to (grpc_server.py). Wraps a ClusterNode."""

    def __init__(self, node: Any):
        self.node = node

    # -- Internal (generic transport) -------------------------------------------

    def handle_internal(self, req: pb.InternalRequest) -> pb.InternalResponse:
        try:
            payload = msgpack.unpackb(req.payload, raw=False) if req.payload else {}
            out = self.node._handle_rpc(req.method, payload)
            return pb.InternalResponse(payload=msgpack.packb(out, use_bin_type=True,
                                                             default=_wire_default))
        except Exception as e:
            return pb.InternalResponse(error=f"{type(e).__name__}: {e}")

    # -- cluster group -------------------------------------------------------------

    def handle_join(self, req: pb.JoinClusterRequest) -> pb.JoinClusterResponse:
        try:
            # Runtime membership: a NEW node is spliced into every raft
            # group's voter set; a seeded node just re-announces (the
            # reference's JoinCluster stub accepted everyone and changed
            # nothing, grpc/server.rs:456).
            self.node._rpc_cluster_join({
                "node_id": req.node.node_id,
                "address": req.node.address,
            })
            members = [
                pb.NodeInfo(node_id=m.node_id, address=m.address,
                            state=m.state.value)
                for m in self.node.members.values()
            ]
            return pb.JoinClusterResponse(accepted=True, members=members)
        except Exception as e:
            return pb.JoinClusterResponse(accepted=False, error=str(e))

    def handle_leave(self, req: pb.LeaveClusterRequest) -> pb.LeaveClusterResponse:
        try:
            if req.node_id in self.node.raft.voters:
                # full runtime removal: shrink every raft group's voter set
                # and re-assign the node's shards to survivors
                self.node.remove_member(req.node_id)
            else:
                self.node._propose({"op": "leave", "node_id": req.node_id})
            return pb.LeaveClusterResponse(ok=True)
        except Exception:
            return pb.LeaveClusterResponse(ok=False)

    def handle_cluster_info(self, req) -> pb.GetClusterInfoResponse:
        info = self.node.cluster_info_dict()
        return pb.GetClusterInfoResponse(
            cluster_id=info["cluster_id"],
            leader_id=info.get("leader_id") or "",
            shard_count=info["shard_count"],
            members=[
                pb.NodeInfo(node_id=m["node_id"], address=m["address"],
                            state=m["state"])
                for m in info["members"]
            ],
        )

    def handle_heartbeat(self, req: pb.HeartbeatRequest) -> pb.HeartbeatResponse:
        out = self.node._rpc_heartbeat({"node_id": req.node_id, "term": req.term})
        return pb.HeartbeatResponse(ok=out["ok"], term=out["term"])

    # -- raft group ------------------------------------------------------------------

    def handle_append_entries(self, req: pb.AppendEntriesRequest) -> pb.AppendEntriesResponse:
        out = self.node.raft.handle_append_entries({
            "term": req.term, "leader_id": req.leader_id,
            "prev_log_index": req.prev_log_index,
            "prev_log_term": req.prev_log_term,
            "entries": [
                {"index": e.index, "term": e.term, "entry_type": e.entry_type,
                 "data": e.data}
                for e in req.entries
            ],
            "leader_commit": req.leader_commit,
        })
        return pb.AppendEntriesResponse(
            term=out["term"], success=out.get("success", False),
            match_index=out.get("match_index", 0),
        )

    def handle_request_vote(self, req: pb.RequestVoteRequest) -> pb.RequestVoteResponse:
        out = self.node.raft.handle_request_vote({
            "term": req.term, "candidate_id": req.candidate_id,
            "last_log_index": req.last_log_index,
            "last_log_term": req.last_log_term,
        })
        return pb.RequestVoteResponse(term=out["term"],
                                      vote_granted=out.get("vote_granted", False))

    def handle_install_snapshot(self, req: pb.InstallSnapshotRequest) -> pb.InstallSnapshotResponse:
        out = self.node.raft.handle_install_snapshot({
            "term": req.term, "leader_id": req.leader_id,
            "last_included_index": req.last_included_index,
            "last_included_term": req.last_included_term,
            "data": req.data,
        })
        return pb.InstallSnapshotResponse(term=out["term"], ok=out.get("ok", False))

    # -- shard group ------------------------------------------------------------------

    def handle_migrate_shard(self, req: pb.MigrateShardRequest) -> pb.MigrateShardResponse:
        try:
            report = self.node.shard_manager.migrate_shard(req.shard_id, req.to_node)
            return pb.MigrateShardResponse(ok=report.verified)
        except Exception as e:
            return pb.MigrateShardResponse(ok=False, error=str(e))

    def handle_rebalance(self, req) -> pb.RebalanceShardsResponse:
        try:
            moves = self.node.shard_manager.rebalance(self.node.healthy_node_ids())
            return pb.RebalanceShardsResponse(ok=True, moves=len(moves))
        except Exception:
            return pb.RebalanceShardsResponse(ok=False, moves=0)

    def handle_shard_info(self, req: pb.GetShardInfoRequest) -> pb.GetShardInfoResponse:
        info = self.node.shard_map.shards.get(req.shard_id)
        if info is None:
            return pb.GetShardInfoResponse(shard_id=req.shard_id, state="unknown")
        return pb.GetShardInfoResponse(
            shard_id=info.shard_id,
            primary_node=info.primary_node,
            replica_nodes=list(info.replica_nodes),
            point_count=info.point_count,
            state=info.state.value,
        )


class GrpcTransport(Transport):
    """Transport over the gRPC ``Internal`` RPC. Register handlers locally
    (same-process nodes short-circuit); remote nodes resolve through the
    address book."""

    def __init__(self, address_book: Optional[Dict[str, str]] = None,
                 timeout_s: float = 2.0, tls=None):
        self.addresses: Dict[str, str] = dict(address_book or {})
        self.timeout_s = timeout_s
        self.tls = tls  # TlsConfig: node-to-node channels go TLS/mTLS
        self._lock = threading.Lock()
        self._local: Dict[str, Callable[[str, Dict[str, Any]], Dict[str, Any]]] = {}
        self._stubs: Dict[str, Callable] = {}

    def set_address(self, node_id: str, address: str) -> None:
        with self._lock:
            self.addresses[node_id] = address
            self._stubs.pop(node_id, None)

    def register(self, node_id: str, handler) -> None:
        with self._lock:
            self._local[node_id] = handler

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._local.pop(node_id, None)

    def _stub(self, node_id: str):
        import os

        with self._lock:
            stub = self._stubs.get(node_id)
            if stub is not None:
                return stub
            # Env override wins (the reference's GRAPE_NODE_{ID}_ADDRESS
            # convention, failover.rs:670-696), then the address book.
            env_key = f"GRAPE_NODE_{node_id.upper().replace('-', '_')}_ADDRESS"
            addr = os.environ.get(env_key) or self.addresses.get(node_id)
            if addr is None:
                raise TransportError(f"no address for node {node_id}")
            if self.tls is not None and self.tls.enabled:
                from grape_vector_db_tpu_torch.server.grpc_server import secure_channel

                channel = secure_channel(addr, self.tls)
            else:
                channel = grpc.insecure_channel(addr)
            stub = channel.unary_unary(
                f"/{SERVICE_NAME}/Internal",
                request_serializer=pb.InternalRequest.SerializeToString,
                response_deserializer=pb.InternalResponse.FromString,
            )
            self._stubs[node_id] = stub
            return stub

    def call(self, src: str, dst: str, method: str, payload: Dict[str, Any],
             timeout_s: float = 1.0) -> Dict[str, Any]:
        with self._lock:
            local = self._local.get(dst)
        if local is not None:
            return local(method, payload)
        stub = self._stub(dst)
        try:
            resp = stub(
                pb.InternalRequest(
                    src_node=src, method=method,
                    payload=msgpack.packb(payload, use_bin_type=True,
                                          default=_wire_default),
                ),
                timeout=max(timeout_s, 0.1),
            )
        except grpc.RpcError as e:
            raise TransportError(f"grpc call {method} to {dst} failed: {e.code()}")
        if resp.error:
            raise TransportError(f"remote error from {dst}.{method}: {resp.error}")
        return msgpack.unpackb(resp.payload, raw=False) if resp.payload else {}

"""Distributed control plane (reference src/distributed/, ~10k LoC).

The reference's hard distributed parts were simulated — Raft replication slept
3-15ms and succeeded with 90% probability (raft.rs:578-603), shard search
returned mock results (shard.rs:789-824), and the inter-node HTTP server was a
logging stub (network.rs:447-502). This package implements them for real:

- raft.py: actual Raft (election, log replication, commit/apply, persistence,
  snapshot/compaction) over a pluggable transport
- transport.py: in-process transport with partition/latency/loss injection
  (the test framework's NetworkSimulator is built in), plus a gRPC binding
- shard.py: hash-range + consistent-hash shard routing and migration
- replication.py: sync/async/quorum replication policies
- failover.py: heartbeat failure detector + recovery coordinator
- load_balancer.py / request_router.py: query admission + routing
- cluster.py / cluster_service.py: membership + one-stop serving bootstrap

Data-plane note: *within* one host's mesh, sharding is SPMD
(grape_vector_db_tpu_torch.parallel) and needs none of this. This layer coordinates
*across* hosts/slices over DCN.
"""

from grape_vector_db_tpu_torch.distributed.types import (
    ClusterConfig,
    ConsistencyLevel,
    NodeInfo,
    NodeState,
    ShardInfo,
    ShardState,
)

__all__ = [
    "ClusterConfig",
    "ConsistencyLevel",
    "NodeInfo",
    "NodeState",
    "ShardInfo",
    "ShardState",
]

"""3-node cluster quick start on the PyTorch + CUDA port (reference
examples/cluster_3node_simple.rs): boot an in-process 3-node cluster (real
Raft + sharding + replication over the in-process transport), write
replicated data, scatter-gather search, status. Every node keeps its index
on ``device``.

Run: python examples_torch/cluster_3node_simple.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
from grape_vector_db_tpu_torch.distributed.types import ClusterConfig, ConsistencyLevel
from grape_vector_db_tpu_torch.types import Document


def main(device: str = "cuda") -> dict:
    dcfg = VectorDbConfig(vector_dimension=32)
    dcfg.index.initial_capacity = 512
    svc = ClusterService(
        ["alpha", "beta", "gamma"],
        cluster_config=ClusterConfig(
            shard_count=8, replica_count=2,
            consistency=ConsistencyLevel.SESSION,
            heartbeat_interval_s=0.3,
            election_timeout_ms=(100, 200), raft_heartbeat_ms=30.0,
        ),
        db_config=dcfg,
        device=device,
    )
    svc.start()
    try:
        print("leader:", svc.leader_node().node_id)

        rng = np.random.default_rng(0)
        docs = [
            Document(id=f"doc-{i}", content=f"body {i}",
                     vector=rng.standard_normal(32).astype(np.float32).tolist())
            for i in range(90)
        ]
        written = svc.upsert(docs)
        print("written:", written)
        total = sum(n.db.store.count() for n in svc.nodes.values())
        print(f"copies across nodes: {total} (replica_count=2 -> 180)")

        hits = svc.search(docs[11].vector, k=3)
        print("top-3:", [(i, round(s, 3)) for i, s in hits])
        assert hits[0][0] == "doc-11"

        health = svc.any_node().cluster_health()
        print(f"health: {health.status}, nodes {health.healthy_nodes}/"
              f"{health.total_nodes}, shards {health.active_shards}")
    finally:
        svc.stop()
    print("cluster_3node_simple OK")
    return {"written": written, "copies": total, "top3": [i for i, _ in hits]}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

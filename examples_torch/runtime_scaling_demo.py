"""Runtime cluster scaling on the PyTorch + CUDA port (beyond the reference's
fixed seed set): boot a 3-node cluster, add a FOURTH node while the cluster
serves traffic (raft voter sets grow through the live leaders, shard
placements re-spread, the newcomer pulls its shards' data, and it
coordinates reads), then retire it again. The reference's JoinCluster stub
accepted every request and changed nothing (grpc/server.rs:456-605); this
is the real thing. Every node, the newcomer too, keeps its index on
``device``.

Run: python examples_torch/runtime_scaling_demo.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
from grape_vector_db_tpu_torch.distributed.raft import RaftConfig
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
        raft_config=RaftConfig(election_timeout_ms=(100, 200),
                               heartbeat_ms=30.0, tick_ms=5.0),
        device=device,
    )
    svc.start()
    try:
        rng = np.random.default_rng(0)
        docs = [
            Document(id=f"doc-{i}", content=f"payload {i}",
                     vector=rng.standard_normal(32).astype(np.float32).tolist())
            for i in range(120)
        ]
        svc.upsert(docs)
        print(f"3-node cluster serving {len(docs)} docs")

        newcomer = svc.add_node("delta")
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            voters_ok = all("delta" in n.raft.voters for n in svc.nodes.values())
            with newcomer._state_lock:
                owned = newcomer._owned_shard_set()
            if voters_ok and owned:
                break
            time.sleep(0.1)
        print(f"delta joined: voter everywhere, owns shards {sorted(owned)}")

        hits = newcomer.search(docs[7].vector, k=3)
        print(f"search via the newcomer: top hit {hits[0][0]} "
              f"(score {hits[0][1]:.3f})")
        assert hits[0][0] == "doc-7"
        out = {"delta_shards": sorted(owned), "newcomer_top1": hits[0][0]}

        svc.remove_node("delta")
        assert "delta" not in svc.nodes
        hits = svc.search(docs[7].vector, k=3)
        print(f"delta retired; survivors still serve: top hit {hits[0][0]}")
        assert hits[0][0] == "doc-7"
        out["survivor_top1"] = hits[0][0]
    finally:
        svc.stop()
    print("runtime scaling demo OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

"""Complete 3-node cluster walkthrough on the PyTorch + CUDA port (reference
examples/cluster_3node_complete.rs): strong-consistency raft writes, session
read-your-writes tokens, node failure -> automatic failover -> recovery, and
cluster introspection at every step. Every node keeps its index on
``device``.

Run: python examples_torch/cluster_3node_complete.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
from grape_vector_db_tpu_torch.distributed.types import (
    ClusterConfig,
    ConsistencyLevel,
    SessionToken,
)
from grape_vector_db_tpu_torch.types import Document


def wait_until(pred, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def main(device: str = "cuda") -> dict:
    dcfg = VectorDbConfig(vector_dimension=32)
    dcfg.index.initial_capacity = 512
    svc = ClusterService(
        ["alpha", "beta", "gamma"],
        cluster_config=ClusterConfig(
            shard_count=8, replica_count=2,
            consistency=ConsistencyLevel.STRONG,  # writes ride the raft log
            heartbeat_interval_s=0.25,
            election_timeout_ms=(100, 200), raft_heartbeat_ms=30.0,
        ),
        db_config=dcfg,
        device=device,
    )
    svc.start()
    out = {}
    try:
        leader = svc.leader_node().node_id
        print("leader:", leader)

        # ---- strong writes with a session token --------------------------------
        rng = np.random.default_rng(0)
        docs = [
            Document(id=f"doc-{i}", content=f"body {i}",
                     vector=rng.standard_normal(32).astype(np.float32).tolist())
            for i in range(60)
        ]
        session = SessionToken()
        svc.upsert(docs, session=session)
        print("session versions:", dict(list(session.versions.items())[:4]), "...")

        # read-your-writes: token-carrying search observes the writes
        hits = svc.search(docs[5].vector, k=3, session=session)
        assert hits[0][0] == "doc-5"
        print("session search top-1:", hits[0])
        out["session_top1"] = hits[0][0]

        # ---- kill a non-leader node, watch failover ---------------------------
        victim = next(n for n in svc.nodes if n != leader)
        print("failing node:", victim)
        svc.sim.fail_node(victim)
        survivors = [n for n in svc.nodes if n != victim]
        assert wait_until(lambda: all(
            svc.nodes[s].members[victim].state.value == "failed"
            for s in survivors
        )), "failure never propagated"
        # placement repair: victim is primary nowhere on survivor maps
        for s in survivors:
            assert all(i.primary_node != victim
                       for i in svc.nodes[s].shard_map.shards.values())
        print("failover complete; searching from a survivor…")
        node = svc.nodes[survivors[0]]
        hits = node.search(docs[20].vector, k=3)
        print("top-3 after failover:", [(i, round(s, 3)) for i, s in hits])
        out["failover_top3"] = [i for i, _ in hits]

        # ---- recovery ----------------------------------------------------------
        svc.sim.recover_node(victim)
        assert wait_until(lambda: all(
            svc.nodes[s].members[victim].state.value == "healthy"
            for s in survivors
        )), "recovery never propagated"
        print("node recovered")

        # ---- introspection -----------------------------------------------------
        status = svc.status()
        for nid, st in status.items():
            print(f"  {nid}: role={st['raft']['role']} docs={st['docs']}")
        out["docs"] = {nid: st["docs"] for nid, st in status.items()}
    finally:
        svc.stop()
    print("cluster_3node_complete OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

"""Complete embedded-mode walkthrough on the PyTorch + CUDA port (reference
examples/embedded_mode_complete.rs): lifecycle state machine, warmup, health
checks, shutdown hooks, filtered + hybrid search, backup, persistence across
reopen, and the close-then-use contract.

Run: python examples_torch/embedded_mode_complete.py [--device cuda|cpu]
"""

import argparse
import tempfile

import numpy as np

from grape_vector_db_tpu_torch import (
    Document,
    EmbeddedConfig,
    EmbeddedVectorDB,
    HybridSearchRequest,
    SearchRequest,
    VectorDbConfig,
)
from grape_vector_db_tpu_torch.embedded import DbState
from grape_vector_db_tpu_torch.engine.filtering import parse_sql_where
from grape_vector_db_tpu_torch.errors import StateError


def main(data_dir: str | None = None, device: str = "cuda") -> dict:
    data_dir = data_dir or tempfile.mkdtemp(prefix="gvdb_embedded_")
    cfg = EmbeddedConfig(
        data_dir=data_dir,
        db=VectorDbConfig(vector_dimension=48),
        health_check_interval_s=0,  # drive checks manually below
    )
    cfg.db.index.initial_capacity = 512

    db = EmbeddedVectorDB(cfg, device=device)
    assert db.state == DbState.READY
    db.lifecycle.add_shutdown_hook(lambda: print("  shutdown hook ran"))

    rng = np.random.default_rng(0)
    docs = [
        Document(id=f"d{i}", title=f"Doc {i}",
                 content=f"document about topic{i % 4} number {i}",
                 vector=rng.standard_normal(48).astype(np.float32).tolist(),
                 metadata={"topic": f"topic{i % 4}", "rank": i})
        for i in range(120)
    ]
    db.upsert(docs)
    print("docs:", db.stats().document_count)

    # semantic search
    hits = db.search(SearchRequest(vector=docs[17].vector, limit=3))
    print("semantic top-1:", hits[0].document.id)
    out = {"semantic_top1": hits[0].document.id}

    # SQL-filtered search (the filter is a mask folded into the device top-k)
    filt = parse_sql_where("topic = 'topic2' AND rank >= 50")
    hits = db.search(SearchRequest(vector=docs[17].vector, limit=5, filter=filt))
    assert all(h.document.metadata["rank"] >= 50 for h in hits)
    print("filtered:", [h.document.id for h in hits])
    out["filtered"] = [h.document.id for h in hits]

    # hybrid (dense + BM25 + fusion)
    hy = db.hybrid_search(HybridSearchRequest(query="topic3 number", limit=5))
    print("hybrid top-1:", hy[0].document.id)
    out["hybrid_top1"] = hy[0].document.id

    # health + backup
    health = db.health_check()
    print("health:", health.status.value)
    backup_path = f"{data_dir}/backup.gvdb"
    db.db.create_backup(backup_path)

    # graceful close drains pending ops and runs hooks
    db.close()
    assert db.state == DbState.CLOSED
    try:
        db.search(SearchRequest(query="x", limit=1))
        raise AssertionError("closed DB accepted a query")
    except StateError:
        print("closed DB correctly raises StateError")

    # reopen: WAL replay + index rebuild
    with EmbeddedVectorDB(cfg, device=device) as db2:
        assert db2.stats().document_count == 120
        hits = db2.search(SearchRequest(vector=docs[17].vector, limit=1))
        assert hits[0].document.id == "d17"
        print("persistence verified across reopen")
        out["reopened_docs"] = db2.stats().document_count
    print("embedded_mode_complete OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

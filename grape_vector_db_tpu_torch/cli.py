"""CLI perf drivers + server entry point (reference src/bin/*, 1217 LoC).

Subcommands mirror the reference's binaries and workloads:
- ``benchmark``            1k docs insert + 100 searches (bin/benchmark.rs)
- ``performance-test``     1k docs batch insert + text-search timing
                           (bin/performance_test.rs)
- ``simple-performance-test`` 3k docs, 30 concurrent queries x 3 rounds,
                           p95/p99/QPS report (bin/simple_performance_test.rs:10-52)
- ``concurrent-insert-test`` 50-doc batch vs sequential, <1s target
                           (bin/concurrent_insert_test.rs:23-30)
- ``storage-analysis``     insert cost with vs without vectors
                           (bin/storage_analysis.rs)
- ``fusion-benchmark``     the 8-strategy fusion comparison with
                           precision/recall/NDCG@10 (src/benchmark.rs)
- ``serve``                start the gRPC + REST single-node server

Usage: ``python -m grape_vector_db_tpu_torch.cli <subcommand> [options]``
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import time
from typing import List

import numpy as np


def _mkdb(dim: int = 384, capacity: int = 8192, path=None, device: str = "cuda"):
    from grape_vector_db_tpu_torch import VectorDatabase, VectorDbConfig

    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.initial_capacity = capacity
    return VectorDatabase(path=path, config=cfg, device=device)


def _mkdocs(n: int, dim: int, with_vectors: bool = True, prefix: str = "doc"):
    from grape_vector_db_tpu_torch import Document

    rng = np.random.default_rng(0)
    docs = []
    for i in range(n):
        docs.append(Document(
            id=f"{prefix}-{i}",
            title=f"Title {i}",
            content=f"content body number {i} about topic{i % 7}",
            vector=rng.standard_normal(dim).astype(np.float32).tolist()
            if with_vectors else None,
            metadata={"group": i % 5},
        ))
    return docs


def cmd_benchmark(args) -> None:
    """bin/benchmark.rs: 1k docs insert + 100 searches."""
    from grape_vector_db_tpu_torch import SearchRequest

    db = _mkdb(args.dim, device=args.device)
    docs = _mkdocs(1000, args.dim)
    t0 = time.perf_counter()
    db.batch_add_documents(docs)
    insert_s = time.perf_counter() - t0
    lats: List[float] = []
    for i in range(100):
        q = docs[i * 7 % 1000].vector
        t0 = time.perf_counter()
        db.vector_search(SearchRequest(vector=q, limit=10))
        lats.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lats)
    print(json.dumps({
        "insert_docs": 1000, "insert_s": round(insert_s, 3),
        "insert_qps": round(1000 / insert_s, 1),
        "searches": 100,
        "avg_ms": round(sum(lat) / len(lat), 2),
        "p95_ms": round(lat[94], 2),
        "search_qps": round(100 / (sum(lat) / 1e3), 1),
    }))


def cmd_performance_test(args) -> None:
    """bin/performance_test.rs: 1k docs + text-search timing."""
    from grape_vector_db_tpu_torch import SearchRequest

    db = _mkdb(args.dim, device=args.device)
    docs = _mkdocs(1000, args.dim)
    t0 = time.perf_counter()
    db.batch_add_documents(docs)
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(50):
        db.text_search(SearchRequest(query=f"topic{i % 7}", limit=10))
    text_s = time.perf_counter() - t0
    print(json.dumps({
        "batch_insert_s": round(insert_s, 3),
        "text_searches": 50,
        "text_search_avg_ms": round(text_s / 50 * 1e3, 2),
    }))


def cmd_simple_performance_test(args) -> None:
    """bin/simple_performance_test.rs:10-52: 3k docs, 30 concurrent x 3 rounds."""
    from grape_vector_db_tpu_torch import SearchRequest

    db = _mkdb(args.dim, device=args.device)
    docs = _mkdocs(3000, args.dim)
    for s in range(0, 3000, 1000):
        db.batch_add_documents(docs[s:s + 1000])
    lats: List[float] = []

    def one(i: int) -> float:
        q = docs[i % 3000].vector
        t0 = time.perf_counter()
        db.vector_search(SearchRequest(vector=q, limit=10))
        return (time.perf_counter() - t0) * 1e3

    t_all = time.perf_counter()
    for _ in range(3):  # 3 rounds of 30 concurrent queries
        with concurrent.futures.ThreadPoolExecutor(max_workers=30) as ex:
            lats.extend(ex.map(one, range(30)))
    wall = time.perf_counter() - t_all
    lat = sorted(lats)
    print(json.dumps({
        "total_queries": len(lats),
        "avg_ms": round(sum(lat) / len(lat), 2),
        "p95_ms": round(lat[int(0.95 * len(lat))], 2),
        "p99_ms": round(lat[int(0.99 * len(lat))], 2),
        "qps": round(len(lats) / wall, 1),
    }))


def cmd_concurrent_insert_test(args) -> None:
    """bin/concurrent_insert_test.rs: 50-doc batch vs sequential, <1s target."""
    db = _mkdb(args.dim, device=args.device)
    db.batch_add_documents(_mkdocs(5, args.dim, prefix="warm"))  # warm jit
    docs = _mkdocs(50, args.dim, prefix="batch")
    t0 = time.perf_counter()
    db.batch_add_documents(docs)
    batch_s = time.perf_counter() - t0
    docs2 = _mkdocs(50, args.dim, prefix="seq")
    t0 = time.perf_counter()
    for d in docs2:
        db.add_document(d)
    seq_s = time.perf_counter() - t0
    print(json.dumps({
        "batch_50_s": round(batch_s, 3),
        "sequential_50_s": round(seq_s, 3),
        "speedup": round(seq_s / batch_s, 1),
        "target_met": batch_s < 1.0,
    }))


def cmd_storage_analysis(args) -> None:
    """bin/storage_analysis.rs: insert cost with vs without vectors."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        db = _mkdb(args.dim, path=td + "/with", device=args.device)
        t0 = time.perf_counter()
        db.batch_add_documents(_mkdocs(500, args.dim, with_vectors=True))
        with_s = time.perf_counter() - t0
        size_with = db.store.get_stats().estimated_size_bytes
        db.close()
        # without explicit vectors: the mock embedder computes them, but the
        # stored payload difference is what the reference measured
        db2 = _mkdb(args.dim, path=td + "/without", device=args.device)
        t0 = time.perf_counter()
        db2.batch_add_documents(_mkdocs(500, args.dim, with_vectors=False))
        without_s = time.perf_counter() - t0
        size_without = db2.store.get_stats().estimated_size_bytes
        db2.close()
    print(json.dumps({
        "with_vectors_s": round(with_s, 3),
        "without_vectors_s": round(without_s, 3),
        "with_vectors_bytes": size_with,
        "without_vectors_bytes": size_without,
    }))


def cmd_fusion_benchmark(args) -> None:
    from grape_vector_db_tpu_torch.bench import BenchmarkConfig, BenchmarkSuite

    cfg = BenchmarkConfig(
        num_queries=args.queries, dataset_size=args.docs, dimension=args.dim,
        warmup_queries=min(100, args.queries // 10),
    )
    suite = BenchmarkSuite(cfg, device=args.device)
    suite.build_dataset()
    dense = suite.run_dense()
    rows = [dense] + suite.run_fusion_comparison()
    for r in rows:
        print(json.dumps({
            "name": r.name, "precision@10": round(r.precision_at_k, 3),
            "recall@10": round(r.recall_at_k, 3), "ndcg@10": round(r.ndcg_at_10, 3),
            "p95_ms": round(r.p95_latency_ms, 2), "qps": round(r.qps, 1),
        }))


def cmd_serve(args) -> None:
    """Single-node server, or one member of a multi-process cluster when
    --node-id/--peers are given (peers: comma list of id=host:port, including
    this node; raft + data plane run over the gRPC Internal transport). The
    database, or the cluster node's, keeps its index on --device."""
    from grape_vector_db_tpu_torch import VectorDatabase, VectorDbConfig, load_config
    from grape_vector_db_tpu_torch.server.grpc_server import build_grpc_server
    from grape_vector_db_tpu_torch.server.rest import RestServer

    cfg = load_config(args.config) if args.config else VectorDbConfig()

    node = None
    adapter = None
    if args.node_id and args.peers:
        from grape_vector_db_tpu_torch.distributed.cluster import ClusterNode
        from grape_vector_db_tpu_torch.distributed.types import ClusterConfig
        from grape_vector_db_tpu_torch.server.cluster_adapter import (
            GrpcClusterAdapter,
            GrpcTransport,
        )

        book = dict(p.split("=", 1) for p in args.peers.split(","))
        transport = GrpcTransport(address_book=book, tls=cfg.tls)
        node = ClusterNode(
            node_id=args.node_id,
            address=book[args.node_id],
            seed_nodes=sorted(book),
            transport=transport,
            cluster_config=ClusterConfig(
                shard_count=args.shard_count, replica_count=args.replica_count
            ),
            db_config=cfg,
            data_path=args.data_dir,
            device=args.device,
        )
        adapter = GrpcClusterAdapter(node)
        db = node.db
        grpc_port = int(book[args.node_id].rsplit(":", 1)[1])
    else:
        db = VectorDatabase(path=args.data_dir, config=cfg, device=args.device)
        grpc_port = args.grpc_port

    server, gport, _ = build_grpc_server(
        db, port=grpc_port, node=adapter, cluster_node=node,
        node_id=args.node_id or "standalone", tls=cfg.tls,
    )
    server.start()
    if node is not None:
        node.start()
        # register membership once the raft group has a leader
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                node.join_cluster()
                break
            except Exception:
                time.sleep(0.25)
    rest = RestServer(db, host=args.host, port=args.rest_port, node=node,
                      tls=cfg.tls)
    host, rport = rest.start()
    print(f"grape-vector-db-tpu serving: grpc=:{gport} rest={host}:{rport}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        rest.stop()
        server.stop(grace=1)
        if node is not None:
            node.stop()
        else:
            db.close()


def cmd_tune(args) -> None:
    """Auto-tune the index's recall/QPS knob against the stored corpus and
    print the chosen setting (VectorDatabase.tune: nprobe for IVF kinds,
    rescore budget for the binary two-stage kind). The tuned value applies
    to this process; persist it in config for servers."""
    import json

    from grape_vector_db_tpu_torch import VectorDatabase, VectorDbConfig, load_config

    cfg = load_config(args.config) if args.config else VectorDbConfig()
    db = VectorDatabase(path=args.data_dir, config=cfg, device=args.device)
    try:
        out = db.tune(target_recall=args.target_recall, k=args.k,
                      hard=args.hard)
        out["documents"] = db.stats().document_count
        print(json.dumps(out), flush=True)
    finally:
        db.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="grape-vector-db-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    # every subcommand's database keeps its index on --device: the card
    # unless the caller asks for the CPU
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device of the index (default: cuda)")

    for name, fn in [
        ("benchmark", cmd_benchmark),
        ("performance-test", cmd_performance_test),
        ("simple-performance-test", cmd_simple_performance_test),
        ("concurrent-insert-test", cmd_concurrent_insert_test),
        ("storage-analysis", cmd_storage_analysis),
    ]:
        sp = sub.add_parser(name, parents=[device])
        sp.add_argument("--dim", type=int, default=384)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("fusion-benchmark", parents=[device])
    sp.add_argument("--dim", type=int, default=384)
    sp.add_argument("--docs", type=int, default=2000)
    sp.add_argument("--queries", type=int, default=200)
    sp.set_defaults(fn=cmd_fusion_benchmark)

    sp = sub.add_parser("tune", parents=[device])
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--target-recall", type=float, default=0.95)
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--hard", action="store_true",
                    help="tune against synthesized held-out queries with a "
                         "joint nprobe x host_rescore sweep (the self-recall "
                         "default overstates probe reachability on capacity "
                         "tiers — see docs/benchmarks.md cap16m_hard)")
    sp.set_defaults(fn=cmd_tune)

    sp = sub.add_parser("serve", parents=[device])
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--grpc-port", type=int, default=50051)
    sp.add_argument("--rest-port", type=int, default=8080)
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--node-id", default=None,
                    help="cluster mode: this node's id (requires --peers)")
    sp.add_argument("--peers", default=None,
                    help="cluster mode: comma list of id=host:port incl. self")
    sp.add_argument("--shard-count", type=int, default=16)
    sp.add_argument("--replica-count", type=int, default=2)
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

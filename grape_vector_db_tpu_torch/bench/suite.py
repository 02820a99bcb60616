"""BenchmarkSuite — recall/QPS harness with fusion-strategy comparison.

Reproduces the reference's metric definitions exactly (benchmark.rs:204-318):
avg/p50/p95/p99/max latency, QPS, precision@k / recall@k / NDCG@10, success
rate — and its 8-strategy fusion comparison (benchmark.rs:130-202): RRF k=60,
RRF k=30, three Linear weight mixes, Normalized, Learned, Adaptive.

Synthetic workload: clustered documents with known relevance judgments — each
query is a noisy copy of a cluster member plus that cluster's keyword, and its
relevant set is the cluster (so precision/recall have exact ground truth).
Default shapes follow benchmark.rs:19-47: 10k docs, 384 dims, 1000 queries,
100 warmup.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu_torch.db import VectorDatabase
from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.types import (
    Document,
    FusionStrategy,
    HybridSearchRequest,
    SearchRequest,
)

__all__ = ["BenchmarkConfig", "BenchmarkResult", "BenchmarkSuite", "ndcg_at_k"]


def ndcg_at_k(retrieved: Sequence[str], relevant: set, k: int = 10) -> float:
    """Binary-relevance NDCG@k (benchmark.rs definition)."""
    dcg = 0.0
    for i, doc_id in enumerate(retrieved[:k]):
        if doc_id in relevant:
            dcg += 1.0 / math.log2(i + 2)
    ideal = sum(1.0 / math.log2(i + 2) for i in range(min(k, len(relevant))))
    return dcg / ideal if ideal > 0 else 0.0


@dataclass
class BenchmarkConfig:
    """benchmark.rs:19-47 defaults."""

    num_queries: int = 1000
    dataset_size: int = 10_000
    dimension: int = 384
    warmup_queries: int = 100
    k: int = 10
    num_clusters: int = 100
    cluster_noise: float = 0.15
    query_noise: float = 0.2
    seed: int = 0


@dataclass
class BenchmarkResult:
    """benchmark.rs:49-78."""

    name: str = ""
    queries: int = 0
    avg_latency_ms: float = 0.0
    p50_latency_ms: float = 0.0
    p95_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    max_latency_ms: float = 0.0
    qps: float = 0.0
    precision_at_k: float = 0.0
    recall_at_k: float = 0.0
    ndcg_at_10: float = 0.0
    success_rate: float = 1.0
    extra: Dict[str, float] = field(default_factory=dict)


# The 8 fusion configurations compared by the reference (benchmark.rs:130-202).
FUSION_VARIANTS: List[Tuple[str, FusionStrategy, float, Tuple[float, float, float]]] = [
    ("rrf_k60", FusionStrategy.RRF, 60.0, (0.7, 0.2, 0.1)),
    ("rrf_k30", FusionStrategy.RRF, 30.0, (0.7, 0.2, 0.1)),
    ("linear_dense", FusionStrategy.LINEAR, 60.0, (0.8, 0.1, 0.1)),
    ("linear_balanced", FusionStrategy.LINEAR, 60.0, (0.4, 0.4, 0.2)),
    ("linear_sparse", FusionStrategy.LINEAR, 60.0, (0.2, 0.6, 0.2)),
    ("normalized", FusionStrategy.NORMALIZED, 60.0, (0.7, 0.2, 0.1)),
    ("learned", FusionStrategy.LEARNED, 60.0, (0.7, 0.2, 0.1)),
    ("adaptive", FusionStrategy.ADAPTIVE, 60.0, (0.7, 0.2, 0.1)),
]


class BenchmarkSuite:
    def __init__(self, config: Optional[BenchmarkConfig] = None,
                 db: Optional[VectorDatabase] = None, device: str = "cuda"):
        self.config = config or BenchmarkConfig()
        self.device = device   # where build_dataset's database keeps its index
        self._rng = np.random.default_rng(self.config.seed)
        self.db = db
        self._judgments: Dict[int, set] = {}
        self._queries: List[Tuple[np.ndarray, str]] = []

    # -- dataset -------------------------------------------------------------------

    def build_dataset(self) -> VectorDatabase:
        c = self.config
        if self.db is None:
            cfg = VectorDbConfig(vector_dimension=c.dimension)
            cfg.device.storage_dtype = "float32"
            cfg.index.initial_capacity = max(4096, c.dataset_size)
            cfg.cache.enabled = False
            self.db = VectorDatabase(config=cfg, device=self.device)
        centers = self._rng.standard_normal((c.num_clusters, c.dimension)).astype(np.float32)
        docs = []
        cluster_members: Dict[int, List[str]] = {i: [] for i in range(c.num_clusters)}
        for i in range(c.dataset_size):
            cl = i % c.num_clusters
            vec = centers[cl] + c.cluster_noise * self._rng.standard_normal(
                c.dimension
            ).astype(np.float32)
            doc_id = f"doc-{i}"
            cluster_members[cl].append(doc_id)
            docs.append(Document(
                id=doc_id,
                title=f"Document {i}",
                content=f"topic{cl} material item {i} about subject{cl}",
                vector=vec.tolist(),
                metadata={"cluster": cl},
            ))
        for s in range(0, len(docs), 4096):
            self.db.batch_add_documents(docs[s:s + 4096])
        # queries: noisy cluster points + the cluster keyword
        self._queries = []
        self._judgments = {}
        for qi in range(c.num_queries + c.warmup_queries):
            cl = int(self._rng.integers(0, c.num_clusters))
            qvec = centers[cl] + c.query_noise * self._rng.standard_normal(
                c.dimension
            ).astype(np.float32)
            self._queries.append((qvec, f"topic{cl}"))
            self._judgments[qi] = set(cluster_members[cl])
        return self.db

    # -- runners --------------------------------------------------------------------

    def _finalize(self, name: str, lats: List[float], precs, recs, ndcgs,
                  failures: int) -> BenchmarkResult:
        lat = np.asarray(sorted(lats)) if lats else np.asarray([0.0])
        total_s = sum(lats) / 1e3 if lats else 1.0

        def pct(p):
            return float(lat[min(int(p * len(lat)), len(lat) - 1)])

        return BenchmarkResult(
            name=name,
            queries=len(lats),
            avg_latency_ms=float(lat.mean()),
            p50_latency_ms=pct(0.50),
            p95_latency_ms=pct(0.95),
            p99_latency_ms=pct(0.99),
            max_latency_ms=float(lat.max()),
            qps=len(lats) / total_s if total_s > 0 else 0.0,
            precision_at_k=float(np.mean(precs)) if precs else 0.0,
            recall_at_k=float(np.mean(recs)) if recs else 0.0,
            ndcg_at_10=float(np.mean(ndcgs)) if ndcgs else 0.0,
            success_rate=1.0 - failures / max(len(lats) + failures, 1),
        )

    def run_dense(self, name: str = "dense_exact") -> BenchmarkResult:
        assert self.db is not None, "call build_dataset() first"
        c = self.config
        lats, precs, recs, ndcgs = [], [], [], []
        failures = 0
        for qi, (qvec, _) in enumerate(self._queries):
            warmup = qi < c.warmup_queries
            t0 = time.perf_counter()
            try:
                hits = self.db.vector_search(SearchRequest(vector=qvec.tolist(),
                                                           limit=c.k))
            except Exception:
                if not warmup:
                    failures += 1
                continue
            ms = (time.perf_counter() - t0) * 1e3
            if warmup:
                continue
            rel = self._judgments[qi]
            got = [h.id for h in hits]
            lats.append(ms)
            precs.append(len(set(got) & rel) / c.k)
            recs.append(len(set(got) & rel) / max(len(rel), 1))
            ndcgs.append(ndcg_at_k(got, rel, 10))
        return self._finalize(name, lats, precs, recs, ndcgs, failures)

    def run_fusion_comparison(self) -> List[BenchmarkResult]:
        """The 8-strategy comparison (benchmark.rs:130-202)."""
        assert self.db is not None, "call build_dataset() first"
        from grape_vector_db_tpu_torch.types import FusionWeights

        c = self.config
        out = []
        for name, strat, rrf_k, (wd, ws, wt) in FUSION_VARIANTS:
            lats, precs, recs, ndcgs = [], [], [], []
            failures = 0
            for qi, (qvec, qtext) in enumerate(self._queries):
                warmup = qi < c.warmup_queries
                req = HybridSearchRequest(
                    query=qtext, dense_vector=qvec.tolist(), limit=c.k,
                    fusion_strategy=strat, rrf_k=rrf_k,
                    weights=FusionWeights(wd, ws, wt), with_snippets=False,
                )
                t0 = time.perf_counter()
                try:
                    res = self.db.hybrid_search(req)
                except Exception:
                    if not warmup:
                        failures += 1
                    continue
                ms = (time.perf_counter() - t0) * 1e3
                if warmup:
                    continue
                rel = self._judgments[qi]
                got = [r.document.id for r in res]
                lats.append(ms)
                precs.append(len(set(got) & rel) / c.k)
                recs.append(len(set(got) & rel) / max(len(rel), 1))
                ndcgs.append(ndcg_at_k(got, rel, 10))
            out.append(self._finalize(name, lats, precs, recs, ndcgs, failures))
        return out

    def run_batched_dense(self, batch: int = 64,
                          name: str = "dense_batched") -> BenchmarkResult:
        """Batched device path — the TPU-native serving regime."""
        assert self.db is not None
        c = self.config
        qs = np.stack([q for q, _ in self._queries[c.warmup_queries:]])
        lats, precs, recs, ndcgs = [], [], [], []
        # warmup
        self.db.vector_search_batch(qs[:batch], c.k)
        for s in range(0, len(qs) - batch + 1, batch):
            t0 = time.perf_counter()
            rows = self.db.vector_search_batch(qs[s:s + batch], c.k)
            ms = (time.perf_counter() - t0) * 1e3
            for j, row in enumerate(rows):
                qi = c.warmup_queries + s + j
                rel = self._judgments[qi]
                got = [h.id for h in row]
                lats.append(ms / batch)
                precs.append(len(set(got) & rel) / c.k)
                recs.append(len(set(got) & rel) / max(len(rel), 1))
                ndcgs.append(ndcg_at_k(got, rel, 10))
        r = self._finalize(name, lats, precs, recs, ndcgs, 0)
        r.extra["batch"] = float(batch)
        return r

"""Hybrid dense+sparse+text search with 5 fusion strategies (reference src/hybrid.rs).

Channels:
- dense:  device index top-k (HNSW in the reference; chunked matmul scan here)
- sparse: BM25 over the inverted index (sparse.rs)
- text:   naive substring scan over the store, paginated 500/page with a 10k doc
  cap (hybrid.rs:619-671)

Fusion strategies (types.rs:226-260):
- RRF         1/(k + rank), k=60 default          (hybrid.rs:421-488)
- LINEAR      weighted raw-score sum              (hybrid.rs:491-559)
- NORMALIZED  min-max normalize then linear       (hybrid.rs:562-616)
- LEARNED     query-type-adaptive weights via FusionModel (hybrid.rs:709-750)
- ADAPTIVE    satisfaction-history weight drift   (hybrid.rs:752-773, 857-897)

Every hit carries a ScoreBreakdown{dense,sparse,text,final} (types.rs:436-446).
Fusion operates on <=max_candidates hits per channel, so it is pure host array
math; the heavy lifting (dense scan, BM25 accumulation) already happened in
batched/vectorized form.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu_torch.config import HybridSearchConfig
from grape_vector_db_tpu_torch.engine.sparse import SparseIndex
from grape_vector_db_tpu_torch.index.base import VectorIndex
from grape_vector_db_tpu_torch.storage.store import DocumentStore
from grape_vector_db_tpu_torch.types import (
    FusionStrategy,
    FusionWeights,
    HybridSearchRequest,
    QueryMetrics,
    ScoreBreakdown,
    SearchResult,
)

__all__ = [
    "classify_query_type",
    "FusionModel",
    "StatisticalFusionModel",
    "HybridSearchEngine",
    "extract_snippet",
]

_TEXT_SCAN_PAGE = 500
_TEXT_SCAN_CAP = 10_000


def classify_query_type(query: str) -> str:
    """Query-type buckets for learned fusion (hybrid.rs FusionModel keying)."""
    q = query.strip()
    lower = q.lower()
    if not q:
        return "empty"
    if q.endswith("?") or lower.split()[0] in (
        "what", "who", "why", "how", "when", "where", "which", "is", "are", "can", "does"
    ):
        return "question"
    if any(c in q for c in "(){};=_") or "::" in q or "fn " in lower or "def " in lower:
        return "code"
    if len(q.split()) <= 2:
        return "keyword"
    return "semantic"


class FusionModel:
    """Trait: query-type -> channel weights, updated from feedback (hybrid.rs:24-60)."""

    def weights_for(self, query_type: str) -> FusionWeights:
        raise NotImplementedError

    def update(self, query_type: str, satisfaction: float) -> None:
        raise NotImplementedError


class StatisticalFusionModel(FusionModel):
    """Per-query-type weight table with learning-rate updates (hybrid.rs:62-167).

    Satisfaction > 0.5 reinforces the current weights' dominant channel for that
    query type; below 0.5 shifts weight toward the others.
    """

    _PRIORS: Dict[str, FusionWeights] = {
        "keyword": FusionWeights(0.3, 0.5, 0.2),
        "semantic": FusionWeights(0.7, 0.2, 0.1),
        "question": FusionWeights(0.6, 0.3, 0.1),
        "code": FusionWeights(0.4, 0.4, 0.2),
        "empty": FusionWeights(0.34, 0.33, 0.33),
    }

    def __init__(self, learning_rate: float = 0.05):
        self.learning_rate = learning_rate
        self._lock = threading.Lock()
        self._weights: Dict[str, FusionWeights] = {
            k: FusionWeights(w.dense, w.sparse, w.text) for k, w in self._PRIORS.items()
        }
        self.update_count = 0

    def weights_for(self, query_type: str) -> FusionWeights:
        with self._lock:
            w = self._weights.get(query_type) or self._weights.setdefault(
                query_type, FusionWeights()
            )
            return FusionWeights(w.dense, w.sparse, w.text)

    def update(self, query_type: str, satisfaction: float) -> None:
        with self._lock:
            w = self._weights.setdefault(query_type, FusionWeights())
            delta = self.learning_rate * (satisfaction - 0.5) * 2.0
            vals = np.asarray([w.dense, w.sparse, w.text], dtype=np.float64)
            dominant = int(np.argmax(vals))
            vals[dominant] = max(0.05, vals[dominant] + delta)
            vals = np.maximum(vals, 0.05)
            vals /= vals.sum()
            w.dense, w.sparse, w.text = float(vals[0]), float(vals[1]), float(vals[2])
            self.update_count += 1


def extract_snippet(content: str, query_terms: Sequence[str], window: int = 80) -> str:
    """First-match window snippet (hybrid.rs:673-699; UTF-8-safe like query.rs:207-254 —
    Python string slicing is code-point-safe by construction)."""
    if not content:
        return ""
    lower = content.lower()
    pos = -1
    for t in query_terms:
        p = lower.find(t.lower())
        if p >= 0 and (pos < 0 or p < pos):
            pos = p
    if pos < 0:
        return content[: 2 * window] + ("…" if len(content) > 2 * window else "")
    start = max(0, pos - window)
    end = min(len(content), pos + window)
    prefix = "…" if start > 0 else ""
    suffix = "…" if end < len(content) else ""
    return f"{prefix}{content[start:end]}{suffix}"


@dataclass
class _ChannelResults:
    dense: List[Tuple[str, float]] = field(default_factory=list)
    sparse: List[Tuple[str, float]] = field(default_factory=list)
    text: List[Tuple[str, float]] = field(default_factory=list)


class HybridSearchEngine:
    """hybrid.rs:169-206 HybridSearchEngine."""

    def __init__(
        self,
        index: VectorIndex,
        sparse_index: SparseIndex,
        store: DocumentStore,
        config: Optional[HybridSearchConfig] = None,
        fusion_model: Optional[FusionModel] = None,
    ):
        self.index = index
        self.sparse = sparse_index
        self.store = store
        self.config = config or HybridSearchConfig()
        self.model = fusion_model or StatisticalFusionModel()
        self._lock = threading.Lock()
        self._history: Deque[QueryMetrics] = deque(maxlen=1000)
        self._adaptive = FusionWeights(
            self.config.dense_weight, self.config.sparse_weight, self.config.text_weight
        )
        self._searches = 0

    # -- channels ---------------------------------------------------------------

    def _dense_channel(self, vector: Optional[Sequence[float]], limit: int):
        if vector is None:
            return []
        return self.index.search(np.asarray(vector, dtype=np.float32), limit)

    def _sparse_channel(self, query: Optional[str], limit: int):
        if not query:
            return []
        return self.sparse.search_bm25(query, limit)

    def _text_channel(self, query: Optional[str], limit: int):
        """Substring scan over the store, capped at 10k docs (the reference
        paginates 500/page to the same cap, hybrid.rs:619-671 — a single
        iter_records pass gives identical results without re-sorting the id
        list per page)."""
        if not query:
            return []
        q = query.lower()
        hits: List[Tuple[str, float]] = []
        scanned = 0
        for rec in self.store.iter_records():
            if scanned >= _TEXT_SCAN_CAP:
                break
            scanned += 1
            score = 0.0
            if q in (rec.title or "").lower():
                score += 0.3
            if q in (rec.content or "").lower():
                score += 0.7
            if score > 0:
                hits.append((rec.id, score))
        hits.sort(key=lambda h: -h[1])
        return hits[:limit]

    # -- fusion ------------------------------------------------------------------

    @staticmethod
    def _rrf(channels: Dict[str, List[Tuple[str, float]]], k: float) -> Dict[str, float]:
        fused: Dict[str, float] = {}
        for hits in channels.values():
            for rank, (id_, _) in enumerate(hits):
                fused[id_] = fused.get(id_, 0.0) + 1.0 / (k + rank + 1)
        return fused

    @staticmethod
    def _minmax(hits: List[Tuple[str, float]]) -> Dict[str, float]:
        if not hits:
            return {}
        vals = [s for _, s in hits]
        lo, hi = min(vals), max(vals)
        if hi - lo < 1e-12:
            return {i: 1.0 for i, _ in hits}
        return {i: (s - lo) / (hi - lo) for i, s in hits}

    def _linear(self, channels, weights: FusionWeights, normalize: bool) -> Dict[str, float]:
        maps = {}
        for name, hits in channels.items():
            maps[name] = self._minmax(hits) if normalize else dict(hits)
        w = {"dense": weights.dense, "sparse": weights.sparse, "text": weights.text}
        fused: Dict[str, float] = {}
        for name, m in maps.items():
            for id_, s in m.items():
                fused[id_] = fused.get(id_, 0.0) + w[name] * s
        return fused

    def _fuse(
        self, req: HybridSearchRequest, channels: Dict[str, List[Tuple[str, float]]]
    ) -> Dict[str, float]:
        strat = req.fusion_strategy
        if strat == FusionStrategy.RRF:
            return self._rrf(channels, req.rrf_k)
        if strat == FusionStrategy.LINEAR:
            return self._linear(channels, req.weights, normalize=False)
        if strat == FusionStrategy.NORMALIZED:
            return self._linear(channels, req.weights, normalize=True)
        if strat == FusionStrategy.LEARNED:
            w = self.model.weights_for(classify_query_type(req.query or ""))
            return self._linear(channels, w, normalize=True)
        if strat == FusionStrategy.ADAPTIVE:
            with self._lock:
                w = FusionWeights(self._adaptive.dense, self._adaptive.sparse, self._adaptive.text)
            return self._linear(channels, w, normalize=True)
        raise ValueError(f"unknown fusion strategy {strat}")

    # -- search --------------------------------------------------------------------

    def search(self, req: HybridSearchRequest,
               allowed_ids: Optional[set] = None) -> List[SearchResult]:
        """``allowed_ids`` (from the filter engine) constrains every channel
        BEFORE fusion/truncation — filtering fused top-k after the fact would
        return too few results (or none) even when many documents match."""
        t0 = time.perf_counter()
        limit = max(1, req.limit)
        cand = max(limit, self.config.max_candidates)
        # Over-fetch when filtered so post-filter channels still fill up.
        fetch = cand if allowed_ids is None else cand * 4

        channels = {
            "dense": self._dense_channel(req.dense_vector, fetch),
            "sparse": self._sparse_channel(req.query, fetch),
            "text": self._text_channel(req.query, fetch),
        }
        if allowed_ids is not None:
            channels = {
                name: [(i, s) for i, s in hits if i in allowed_ids][:cand]
                for name, hits in channels.items()
            }
        fused = self._fuse(req, channels)
        dense_m = dict(channels["dense"])
        sparse_m = dict(channels["sparse"])
        text_m = dict(channels["text"])

        ranked = sorted(fused.items(), key=lambda kv: -kv[1])
        if req.score_threshold is not None:
            ranked = [(i, s) for i, s in ranked if s >= req.score_threshold]
        ranked = ranked[:limit]

        terms = (req.query or "").split()
        out: List[SearchResult] = []
        for id_, score in ranked:
            rec = self.store.get(id_)
            if rec is None:
                continue
            doc = rec.to_document()
            snippet = extract_snippet(rec.content, terms) if req.with_snippets else None
            out.append(
                SearchResult(
                    document=doc,
                    score=score,
                    snippet=snippet,
                    breakdown=ScoreBreakdown(
                        dense_score=dense_m.get(id_),
                        sparse_score=sparse_m.get(id_),
                        text_score=text_m.get(id_),
                        final_score=score,
                    ),
                )
            )
        with self._lock:
            self._searches += 1
        _ = (time.perf_counter() - t0) * 1e3
        return out

    # -- feedback loop (hybrid.rs:916-935) -------------------------------------------

    def record_query_metrics(self, metrics: QueryMetrics) -> None:
        with self._lock:
            self._history.append(metrics)
        if metrics.satisfaction is not None:
            qt = classify_query_type(metrics.query)
            self.model.update(qt, metrics.satisfaction)
            self._drift_adaptive(metrics.satisfaction)

    def _drift_adaptive(self, satisfaction: float) -> None:
        """Adaptive weight drift (hybrid.rs:752-773): on low satisfaction, move
        weight from the dominant channel toward the others."""
        with self._lock:
            vals = np.asarray(
                [self._adaptive.dense, self._adaptive.sparse, self._adaptive.text]
            )
            dominant = int(np.argmax(vals))
            step = 0.02 * (0.5 - satisfaction) * 2.0  # positive when unsatisfied
            vals[dominant] -= step * 2
            vals += step
            vals = np.clip(vals, 0.05, None)
            vals /= vals.sum()
            self._adaptive = FusionWeights(float(vals[0]), float(vals[1]), float(vals[2]))

    def get_stats(self) -> Dict[str, float]:
        with self._lock:
            sats = [m.satisfaction for m in self._history if m.satisfaction is not None]
            return {
                "searches": float(self._searches),
                "history": float(len(self._history)),
                "avg_satisfaction": float(np.mean(sats)) if sats else 0.0,
                "adaptive_dense": self._adaptive.dense,
                "adaptive_sparse": self._adaptive.sparse,
                "adaptive_text": self._adaptive.text,
            }

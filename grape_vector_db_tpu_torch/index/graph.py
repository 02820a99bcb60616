"""GraphDeviceIndex — the HNSW counterpart: bulk-built k-NN graph + batched beam.

PyTorch counterpart of ``grape_vector_db_tpu/index/graph.py``, with the same
semantics:

- the graph is bulk-built on the device (NN-descent, ``ops/graph.py``) over
  the graph store, a ``FlatDeviceIndex`` whose slot space the neighbour
  lists index; there is no per-insert rebuild;
- inserts after a build go to a "fresh" flat region that is scanned exactly
  and merged into results; when it exceeds ``rebuild_ratio`` of the graph
  (or on ``optimize()``) the graph is rebuilt over everything, so bulk
  ingest rebuilds at every ``rebuild_ratio`` of growth;
- search is a batched beam over the graph (entry points from a k-means
  probe, each centroid's nearest live row) + an exact scan of the fresh
  region + a host merge; deletes tombstone the validity mask (the beam still
  routes through a deleted node but never returns it).

The beam's and the build's candidate scores go through ``gather_dots``,
which launches the hand-written kernel on a CUDA tensor: the reference
gates its kernel off on every device, the port does not. Queries are not
padded to a bucket (eager PyTorch needs no fixed shapes; each query's
result depends on that query alone). There is no masked search
(``supports_mask`` is False): the planner over-fetches and filters on the
host.

Parameter mapping to the reference's HNSW: ``m`` -> degree ``2 * m``,
``ef_search`` -> pool size, ``ef_construction`` -> NN-descent rounds.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex
from grape_vector_db_tpu_torch.ops.distance import prepare_queries, scored_topk
from grape_vector_db_tpu_torch.ops.graph import beam_search, build_knn_graph
from grape_vector_db_tpu_torch.ops.kmeans import kmeans
from grape_vector_db_tpu_torch.ops.topk import top_k
from grape_vector_db_tpu_torch.utils.buckets import next_bucket

__all__ = ["GraphDeviceIndex"]


def _probe_entries(q: torch.Tensor, centroids: torch.Tensor, reps: torch.Tensor, e: int,
                   metric: str) -> torch.Tensor:
    """Per-query entry points [B, e]: the top-e centroids' representative rows."""
    qp = prepare_queries(q, metric)
    dots = qp @ centroids.T
    if metric == "cosine":
        cn = torch.linalg.vector_norm(centroids, dim=1)
        dots = dots / torch.clamp(cn, min=1e-12)[None, :]
    elif metric == "euclidean":
        c2 = torch.sum(centroids * centroids, dim=1)[None, :]
        dots = -(torch.sum(qp * qp, dim=1, keepdim=True) - 2 * dots + c2)
    _, top = top_k(dots, min(e, centroids.shape[0]))
    return reps[top]


def _tensor(x, dtype: torch.dtype, device: torch.device) -> Optional[torch.Tensor]:
    return None if x is None else torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


class GraphDeviceIndex(VectorIndex):
    kind = "graph"

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        m: int = 16,
        ef_search: int = 128,
        ef_construction: int = 200,
        n_entries: int = 64,
        expand: int = 8,
        rebuild_ratio: float = 0.25,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        use_pallas: bool = True,
        device: str | torch.device = "cuda",
    ):
        self._dim = dimension
        self.metric = metric
        self.device = torch.device(device)
        self.m = m
        # Degree 2*m, HNSW's max_m0 convention: the extra edges let
        # NN-descent converge.
        self.degree = 2 * m
        self.pool = next_bucket(max(ef_search, 16), base=16)
        self.expand = expand
        # ef_construction -> NN-descent rounds (HNSW spends ~ef_c work per
        # insert; NN-descent spends `rounds` full passes).
        self.build_rounds = max(4, min(12, ef_construction // 16))
        self.n_entries = n_entries
        self.rebuild_ratio = rebuild_ratio
        self._lock = threading.RLock()
        # Graph region: a flat index whose slot space the neighbour lists index.
        self._graph_store = FlatDeviceIndex(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=initial_capacity, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target, device=self.device)
        self.neighbors: Optional[torch.Tensor] = None   # [nb_cap, degree] int32
        self.entries: Optional[torch.Tensor] = None     # [E] int32 (small graphs)
        self.centroids: Optional[torch.Tensor] = None   # [L, D] f32 (probe entries)
        self.reps: Optional[torch.Tensor] = None        # [L] int32
        self._graph_n = 0   # slots covered by the graph (high-water at build)
        self._nb_cap = 0    # rows of the store the graph spans
        # Fresh region: exact-scanned buffer of post-build inserts.
        self._fresh = FlatDeviceIndex(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=1024, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target, device=self.device)
        self.search_iters = max(4, self.pool // max(expand, 1))
        self.builds = 0

    # -- properties -----------------------------------------------------------

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._graph_store) + len(self._fresh)

    @property
    def is_built(self) -> bool:
        return self.neighbors is not None

    # -- mutation -------------------------------------------------------------

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        with self._lock:
            # Upsert semantics: drop any existing copies first.
            existing = [i for i in ids
                        if self._graph_store.contains(i) or self._fresh.contains(i)]
            if existing:
                self._graph_store.remove_batch(existing)
                self._fresh.remove_batch(existing)
            self._fresh.add_batch(ids, vectors)
            graph_n = len(self._graph_store)
            if (self.neighbors is None and len(self._fresh) >= 256) or (
                    graph_n and len(self._fresh) > self.rebuild_ratio * graph_n):
                self._rebuild_locked()

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            return self._graph_store.remove_batch(ids) + self._fresh.remove_batch(ids)

    def clear(self) -> None:
        with self._lock:
            self._graph_store.clear()
            self._fresh.clear()
            self.neighbors = None
            self.entries = None
            self.centroids = None
            self.reps = None
            self._graph_n = 0

    def optimize(self) -> None:
        """Bulk (re)build the graph over everything (absorbs the fresh region)."""
        with self._lock:
            self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        f_ids, f_vecs = self._fresh.get_all()
        if f_ids:
            self._graph_store.add_batch(f_ids, f_vecs)
            self._fresh.clear()
        if len(self._graph_store) < 2:
            self.neighbors = None
            return
        gs = self._graph_store
        self._graph_n = gs._high_water
        # The graph spans the slot range rounded up to a bucket; padding rows
        # are masked out by `valid` everywhere.
        self._nb_cap = min(next_bucket(self._graph_n, base=64), gs.capacity)
        nb = build_knn_graph(
            gs.vectors[:self._nb_cap], gs.norms[:self._nb_cap], gs.valid[:self._nb_cap],
            m=self.degree, rounds=self.build_rounds, nn_sample=min(self.degree, 8),
            metric=self.metric)
        self.neighbors = torch.from_numpy(nb).to(self.device)
        # Entry points: a bare kNN graph is not navigable from static entries
        # at scale, so search probes k-means centroids per query and enters
        # the graph at each probed centroid's nearest live row.
        live = [s for s in range(self._graph_n) if gs._slot_to_id[s] is not None]
        n_live = len(live)
        n_cent = min(4096, max(self.n_entries, next_bucket(n_live // 32, base=64)))
        if n_live > n_cent:
            sample = np.asarray(live, dtype=np.int64)
            if n_live > 65536:
                sample = np.random.default_rng(0).choice(sample, 65536, replace=False)
            # the sample is indexed on the device: no readback of the store
            train = gs.vectors[torch.from_numpy(sample).to(self.device)].to(torch.float32)
            self.centroids, _ = kmeans(train, k=n_cent, iters=8)
            # representative = nearest live row per centroid (exact top-1)
            _, rep_idx = scored_topk(
                self.centroids, gs.vectors[:self._nb_cap], gs.norms[:self._nb_cap],
                gs.valid[:self._nb_cap], k=1, metric=self.metric, mode="exact")
            self.reps = rep_idx[:, 0].to(torch.int32)
            self.entries = None
        else:
            self.centroids = None
            self.reps = None
            step = max(1, n_live // self.n_entries)
            self.entries = torch.tensor(live[::step][:self.n_entries], dtype=torch.int32,
                                        device=self.device)
        self.builds += 1

    def load_state(self, *, graph_store: dict, fresh: dict, neighbors, entries, centroids,
                   reps, graph_n: int, nb_cap: int, builds: int) -> None:
        """Take over the state of a JAX ``GraphDeviceIndex`` read back as
        numpy: ``graph_store`` and ``fresh`` hold the keyword arguments of
        ``FlatDeviceIndex.load_state`` for its two flat indexes; then its
        ``neighbors``, ``entries``, ``centroids``, ``reps`` (each None where
        unset), ``_graph_n``, ``_nb_cap`` and ``builds``."""
        dev = self.device
        with self._lock:
            self._graph_store.load_state(**graph_store)
            self._fresh.load_state(**fresh)
            self.neighbors = _tensor(neighbors, torch.int32, dev)
            self.entries = _tensor(entries, torch.int32, dev)
            self.centroids = _tensor(centroids, torch.float32, dev)
            self.reps = _tensor(reps, torch.int32, dev)
            self._graph_n = int(graph_n)
            self._nb_cap = int(nb_cap)
            self.builds = int(builds)

    # -- search ---------------------------------------------------------------

    def search_batch(self, queries: np.ndarray, k: int,
                     mask=None) -> List[List[SearchHit]]:
        if mask is not None:
            raise NotImplementedError(
                "graph index has no masked search; the planner falls back to "
                "over-fetch + host post-filter (supports_mask=False)")
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        if b == 0 or len(self) == 0:
            return [[] for _ in range(b)]
        with self._lock:
            if self.neighbors is None:
                return self._fresh_plus_graph_exact(queries, k)
            gs = self._graph_store
            nb = self._nb_cap
            q_dev = torch.from_numpy(queries).to(self.device)
            if self.centroids is not None:
                entries = _probe_entries(q_dev, self.centroids, self.reps,
                                         e=self.n_entries, metric=self.metric)
            else:
                entries = self.entries
            vals, idxs = beam_search(
                q_dev, gs.vectors[:nb], gs.norms[:nb], gs.valid[:nb], entries,
                self.neighbors,
                # over-fetch 2k: the pool may hold duplicate copies of a node
                # (the dedup is approximate); the host merge dedupes
                k=min(2 * k, self.pool), pool=self.pool, expand=self.expand,
                iters=self.search_iters, metric=self.metric)
            graph_hits = gs.hits_from_slots(vals.cpu().numpy(), idxs.cpu().numpy())
            # Rows written into the graph store after the last build lie
            # beyond the graph's slot range: scan them exactly.
            extra_hits = self._post_build_hits(queries, b, k)
            fresh_hits = (self._fresh.search_batch(queries, k) if len(self._fresh)
                          else [[] for _ in range(b)])
        out: List[List[SearchHit]] = []
        for g, e, f in zip(graph_hits, extra_hits, fresh_hits):
            merged: Dict[str, float] = {}
            for id_, s in g + e + f:
                if id_ not in merged or s > merged[id_]:
                    merged[id_] = s
            ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:k]
            out.append([(i, float(s)) for i, s in ranked])
        return out

    def _post_build_hits(self, queries: np.ndarray, b: int, k: int):
        """Slots written into the graph store after the last build (possible
        through slot reuse on upsert) are reachable only by exact scan."""
        gs = self._graph_store
        if gs._high_water <= self._graph_n:
            return [[] for _ in range(b)]
        vals, idxs = gs.raw_topk(queries, k)
        keep = []
        for row in gs.hits_from_slots(vals[:b], idxs[:b]):
            keep.append([(i, s) for i, s in row
                         if gs._id_to_slot.get(i, -1) >= self._graph_n])
        return keep

    def _fresh_plus_graph_exact(self, queries: np.ndarray, k: int):
        """Before the first build: everything is exact."""
        a = self._fresh.search_batch(queries, k) if len(self._fresh) else None
        g = self._graph_store.search_batch(queries, k) if len(self._graph_store) else None
        if a is None:
            return g or [[] for _ in range(queries.shape[0])]
        if g is None:
            return a
        out = []
        for ra, rg in zip(a, g):
            merged = {i: s for i, s in ra}
            for i, s in rg:
                if i not in merged or s > merged[i]:
                    merged[i] = s
            out.append(sorted(merged.items(), key=lambda kv: -kv[1])[:k])
        return out

    # -- introspection --------------------------------------------------------

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        v = self._graph_store.get_vector(id_)
        return v if v is not None else self._fresh.get_vector(id_)

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        g_ids, g_vecs = self._graph_store.get_all()
        f_ids, f_vecs = self._fresh.get_all()
        return g_ids + f_ids, np.concatenate([g_vecs, f_vecs], axis=0)

    def get_stats(self) -> IndexStats:
        gs = self._graph_store.get_stats()
        return IndexStats(
            point_count=len(self),
            dimension=self._dim,
            capacity=gs.capacity,
            kind=self.kind,
            is_built=self.is_built,
            memory_usage_mb=gs.memory_usage_mb + (self._graph_n * self.degree * 4) / 1e6,
            extra={
                "m": float(self.m),
                "degree": float(self.degree),
                "pool": float(self.pool),
                "graph_nodes": float(self._graph_n),
                "fresh": float(len(self._fresh)),
                "builds": float(self.builds),
            },
        )

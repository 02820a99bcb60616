"""VectorDatabase — the library facade (reference src/lib.rs:233-788).

PyTorch counterpart of ``grape_vector_db_tpu/db.py``. Owns the document store,
the device index, the sparse index, and the unified query engine. Batch-first
ingest (single add delegates to batch, lib.rs:309-356), fixed mutation order
on delete (index before storage, lib.rs:380-390), rebuild_index from stored
documents (lib.rs:560-581), and the document-oriented search with text
fallback (lib.rs:459-540).

Ported: every single-chip index kind (flat, binary, int8, pq, the IVF family
ivf / ivf_int8 / ivf_int4, ivf_pq, the projected ivf_int8_proj /
ivf_int4_proj, and graph) and the mesh-sharded kinds (``sharded_flat``,
``sharded_ivf`` / ``_int8`` / ``_int4`` and the two projected ones, over a
mesh of the host's devices, ``parallel/mesh.py``) over the memory or the file
store (``path``), with ingest (device-direct for text-only batches on the
flat kinds, pipelined), search, listing, delete, rebuild, optimize, tuning,
index snapshots, backups, the enterprise wrappers, stats and health.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.config import VectorDbConfig
from grape_vector_db_tpu_torch.engine.filtering import FilterEngine
from grape_vector_db_tpu_torch.engine.hybrid import HybridSearchEngine
from grape_vector_db_tpu_torch.engine.planner import QueryEngine
from grape_vector_db_tpu_torch.engine.sparse import SparseIndex
from grape_vector_db_tpu_torch.errors import InvalidArgumentError, StateError
from grape_vector_db_tpu_torch.index import (BinaryDeviceIndex, FlatDeviceIndex,
                                             GraphDeviceIndex, Int4IvfDeviceIndex,
                                             Int8DeviceIndex, Int8IvfDeviceIndex, IvfDeviceIndex,
                                             IvfPqDeviceIndex, PqDeviceIndex,
                                             ProjectedInt4IvfIndex, ProjectedInt8IvfIndex,
                                             VectorIndex)
from grape_vector_db_tpu_torch.services.embeddings import EmbeddingProvider, create_provider
from grape_vector_db_tpu_torch.services.metrics import MetricsCollector
from grape_vector_db_tpu_torch.storage import (
    DocumentStore,
    FileDocumentStore,
    MemoryDocumentStore,
)
from grape_vector_db_tpu_torch.storage.file import compress, decompress
from grape_vector_db_tpu_torch.storage.msgpack_codec import packb, unpackb
from grape_vector_db_tpu_torch.types import (
    Document,
    DocumentRecord,
    HybridSearchRequest,
    ScoredPoint,
    SearchRequest,
    SearchResult,
)

__all__ = ["VectorDatabase", "DatabaseStats", "build_index"]


@dataclass
class DatabaseStats:
    """embedded.rs DatabaseStats / lib.rs stats aggregation."""

    document_count: int = 0
    index_size: int = 0
    index_kind: str = ""
    index_memory_mb: float = 0.0
    storage_size_bytes: int = 0
    sparse_vocabulary: int = 0
    cache_hit_rate: float = 0.0
    uptime_s: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)


def _build_sharded_index(kind: str, config: VectorDbConfig, mesh,
                         device: str | torch.device = "cuda") -> VectorIndex:
    """The mesh-sharded kinds (``parallel/mesh.py``): one index over a mesh
    of this host's devices (``local_devices(device)``), shaped by
    ``config.device``'s ``n_shards`` / ``n_replicas`` / axis names unless a
    ``mesh`` is given."""
    from grape_vector_db_tpu_torch.parallel import mesh as pmesh

    dev = config.device
    if mesh is None:
        local = pmesh.local_devices(device)
        if dev.n_replicas > 1:
            mesh = pmesh.make_mesh_2d(dev.n_replicas, n_shards=dev.n_shards,
                                      replica_axis=dev.replica_axis,
                                      shard_axis=dev.shard_axis, devices=local)
        else:
            mesh = pmesh.make_mesh(n_shards=dev.n_shards, shard_axis=dev.shard_axis,
                                   devices=local)
    replica = dev.replica_axis if dev.replica_axis in mesh.axis_names else None
    n_sh = mesh.shape[dev.shard_axis]
    if kind == "sharded_flat":
        return pmesh.ShardedFlatIndex(
            dimension=config.vector_dimension, mesh=mesh, metric=config.distance,
            storage_dtype=dev.storage_dtype,
            shard_capacity=max(128, -(-config.index.initial_capacity // n_sh)),
            shard_axis=dev.shard_axis, search_mode=dev.search_mode,
            recall_target=dev.recall_target, replica_axis=replica)
    common = dict(mesh=mesh, shard_axis=dev.shard_axis, replica_axis=replica,
                  metric=config.distance, storage_dtype=dev.storage_dtype,
                  initial_capacity=config.index.initial_capacity,
                  growth_factor=dev.growth_factor, nlist=config.index.nlist,
                  nprobe=config.index.nprobe, train_size=config.index.ivf_train_size,
                  search_mode=dev.search_mode, recall_target=dev.recall_target,
                  use_pallas=dev.use_pallas)
    if kind == "sharded_ivf":
        return pmesh.ShardedIvfIndex(config.vector_dimension, **common)
    codes = dict(common, rescore=config.index.int8_rescore,
                 keep_bf16=config.index.ivf_int8_keep_bf16)
    if kind == "sharded_ivf_int8":
        return pmesh.ShardedInt8IvfIndex(config.vector_dimension, **codes)
    if kind == "sharded_ivf_int4":
        return pmesh.ShardedInt4IvfIndex(config.vector_dimension, **codes)
    if kind in ("sharded_ivf_int8_proj", "sharded_ivf_int4_proj"):
        from grape_vector_db_tpu_torch.index.ivf_proj import get_sharded_projected_cls

        return get_sharded_projected_cls("int4" if "int4" in kind else "int8")(
            config.vector_dimension, **codes, proj_dim=config.index.proj_dim)
    raise InvalidArgumentError(f"unknown sharded index kind: {kind}")


def build_index(config: VectorDbConfig, device: str | torch.device = "cuda",
                mesh=None) -> VectorIndex:
    """The index for ``config`` on ``device``, with the arguments the JAX
    factory passes: every kind of the reference, the ``sharded_*`` kinds
    over ``mesh`` or a mesh of the host's devices. ``auto_shard`` upgrades
    ``flat`` / ``ivf`` / ``ivf_int8`` / ``ivf_int4`` to their sharded twins
    where ``local_devices(device)`` holds more than one device, as in the
    reference: on the CPU or one GPU it builds the kind as asked."""
    from grape_vector_db_tpu_torch.parallel import mesh as pmesh

    kind = config.index.kind
    if (config.device.auto_shard and kind in ("flat", "ivf", "ivf_int8", "ivf_int4")
            and len(pmesh.local_devices(device)) > 1):
        kind = "sharded_" + kind
    if kind.startswith("sharded_"):
        return _build_sharded_index(kind, config, mesh, device)
    common = dict(
        dimension=config.vector_dimension,
        metric=config.distance,
        storage_dtype=config.device.storage_dtype,
        initial_capacity=config.index.initial_capacity,
        growth_factor=config.device.growth_factor,
        search_mode=config.device.search_mode,
        device=device,
    )
    if kind == "flat":
        return FlatDeviceIndex(**common)
    if kind == "binary":
        q = config.quantization
        return BinaryDeviceIndex(**common, threshold=q.threshold,
                                 rescore_ratio=config.index.rescore_ratio,
                                 keep_vectors=q.keep_vectors, prescan=q.prescan)
    if kind == "pq":
        return PqDeviceIndex(**common, n_sub=config.index.pq_n_sub,
                             nbits=config.index.pq_nbits,
                             rescore_ratio=config.index.rescore_ratio)
    if kind == "int8":
        return Int8DeviceIndex(**common, rescore=config.index.int8_rescore)
    if kind == "graph":
        return GraphDeviceIndex(**common, m=config.index.m,
                                ef_search=config.index.ef_search,
                                ef_construction=config.index.ef_construction)
    ivf = dict(common, nlist=config.index.nlist, nprobe=config.index.nprobe,
               train_size=config.index.ivf_train_size)
    if kind == "ivf":
        return IvfDeviceIndex(**ivf)
    if kind == "ivf_pq":
        return IvfPqDeviceIndex(**ivf, n_sub=config.index.pq_n_sub,
                                nbits=config.index.pq_nbits,
                                residual=config.index.pq_residual,
                                resident=config.index.pq_resident,
                                rescore_k=config.index.pq_rescore_k)
    codes = dict(ivf, rescore=config.index.int8_rescore,
                 keep_bf16=config.index.ivf_int8_keep_bf16)
    if kind == "ivf_int8":
        return Int8IvfDeviceIndex(**codes)
    if kind == "ivf_int4":
        return Int4IvfDeviceIndex(**codes)
    if kind in ("ivf_int8_proj", "ivf_int4_proj"):
        cls = ProjectedInt4IvfIndex if kind == "ivf_int4_proj" else ProjectedInt8IvfIndex
        return cls(**codes, proj_dim=config.index.proj_dim)
    raise InvalidArgumentError(f"unknown index kind: {kind}")


def _stack_vectors(docs: Sequence[Document], dim: int) -> np.ndarray:
    """[N, dim] f32 from per-doc vectors. ``Document.vector`` may be a numpy
    array (the idiomatic way a Python caller holds embeddings) — that path
    stacks without per-element conversion; Python lists pay the unavoidable
    PyFloat->f32 walk."""
    if isinstance(docs[0].vector, np.ndarray):
        out = np.empty((len(docs), dim), np.float32)
        for i, d in enumerate(docs):
            v = d.vector
            if isinstance(v, np.ndarray) and v.shape == (dim,):
                out[i] = v
            else:
                out[i] = np.asarray(v, dtype=np.float32).reshape(dim)
        return out
    return np.asarray([d.vector for d in docs], dtype=np.float32)


class VectorDatabase:
    def __init__(
        self,
        path: Optional[str] = None,
        config: Optional[VectorDbConfig] = None,
        embedder: Optional[EmbeddingProvider] = None,
        store: Optional[DocumentStore] = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or VectorDbConfig()
        if self.config.embedding.dimension != self.config.vector_dimension:
            self.config.embedding.dimension = self.config.vector_dimension
        self.path = path
        if store is not None:
            self.store = store
        elif path:
            self.store = FileDocumentStore(
                os.path.join(path, "store"),
                sync_writes=self.config.persistence.sync_writes,
            )
        else:
            self.store = MemoryDocumentStore()
        self.device = torch.device(device)
        self.index = build_index(self.config, device=self.device)
        self.sparse = SparseIndex(bm25=self.config.hybrid.bm25, config=self.config.sparse)
        self.embedder = embedder or create_provider(self.config.embedding, device=self.device)
        if self.config.cache.enabled:
            from grape_vector_db_tpu_torch.engine.performance import CachingEmbedder

            self.embedder = CachingEmbedder(
                self.embedder,
                cache_size=self.config.cache.embedding_cache_size,
                ttl_s=self.config.cache.ttl_seconds,
            )
        self.metrics = MetricsCollector()
        if hasattr(self.index, "counters"):
            self.metrics.add_counters(self.index.counters)
        self.filter_engine = FilterEngine()
        self.hybrid_engine = HybridSearchEngine(
            self.index, self.sparse, self.store, self.config.hybrid
        )
        self.engine = QueryEngine(
            self.index,
            self.sparse,
            self.store,
            config=self.config.query,
            metrics=self.metrics,
            hybrid=self.hybrid_engine,
            cache_size=self.config.cache.query_cache_size,
            cache_ttl_s=self.config.cache.ttl_seconds,
            enable_cache=self.config.cache.enabled,
            filter_engine=self.filter_engine,
        )
        self._lock = threading.RLock()
        # single worker carrying the BM25 phase of each ingest batch (see
        # batch_add_documents); one thread keeps sparse updates ordered
        self._sparse_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gvdb-sparse")
        self._closed = False
        self._t0 = time.monotonic()
        self.auth = None        # set by enable_enterprise()
        self.resilience = None
        # Rebuild device state from the durable store on open.
        if self.store.count():
            self.rebuild_index()

    @property
    def write_lock(self) -> threading.RLock:
        """The database's write lock (reentrant), exposed for callers that
        need a compound check-then-act to be atomic against concurrent
        writes (e.g. the cluster's upsert-if-newer reconcile: read the
        stored revision, compare timestamps, conditionally upsert)."""
        return self._lock

    # -- ingest (batch-first, lib.rs:309-356) -----------------------------------

    def add_document(self, doc: Document) -> str:
        return self.batch_add_documents([doc])[0]

    def batch_add_documents(self, docs: Sequence[Document]) -> List[str]:
        if self._closed:
            raise StateError("database is closed")
        if not docs:
            return []
        for d in docs:
            if not d.id:
                raise InvalidArgumentError("document id must be non-empty")
        # Embed missing vectors in one provider batch. Providers with a
        # batch-array path (mock, device-hash) fill ndarray rows — no
        # per-float boxing on the write path (bulk ingest texts are mostly
        # unique, so skipping the CachingEmbedder wrapper here loses nothing;
        # the query path still goes through the cache).
        missing = [d for d in docs if d.vector is None]
        dim = self.config.vector_dimension
        embedded_all: Optional[np.ndarray] = None
        device_ingest = None  # (chunks, drain) from embed_ingest
        if missing:
            texts = [f"{d.title or ''} {d.content}".strip() for d in missing]
            prov = self.embedder
            ing_fn = getattr(prov, "embed_ingest", None) or getattr(
                getattr(prov, "inner", None), "embed_ingest", None)
            arr_fn = getattr(prov, "embed_array", None) or getattr(
                getattr(prov, "inner", None), "embed_array", None)
            if (ing_fn is not None
                    and len(missing) == len(docs)
                    and hasattr(self.index, "add_batch_device")
                    and len({d.id for d in docs}) == len(docs)):
                # text-only batch with unique ids on an index that takes
                # device rows: the embedder's outputs stay on the device for
                # the index write, and the store's f16 copy is drained after
                # the write is issued, so the copy overlaps it
                device_ingest = ing_fn(texts)
            elif arr_fn is not None:
                arr = arr_fn(texts)
                for d, row in zip(missing, arr):
                    d.vector = row
                if len(missing) == len(docs):
                    # text-only batch: the embed output IS the batch matrix
                    embedded_all = arr
            else:
                for d, e in zip(missing, self.embedder.generate_embeddings(texts)):
                    d.vector = list(e)
        if embedded_all is not None:
            if embedded_all.shape[1] != dim:
                raise InvalidArgumentError(
                    f"embedder dim {embedded_all.shape[1]} != {dim}")
        elif device_ingest is None:
            for d in docs:
                if len(d.vector) != dim:
                    raise InvalidArgumentError(
                        f"document {d.id}: vector dim {len(d.vector)} != {dim}"
                    )
        with self._lock:
            ids = [d.id for d in docs]
            # BM25 indexing overlaps the other host phases on a worker
            # thread; joined before return, so BM25 reads its writes on
            # return.
            sparse_fut = self._sparse_pool.submit(
                self.sparse.add_documents,
                ids, [f"{d.title or ''} {d.content}".strip() for d in docs],
            )
            err: Optional[BaseException] = None
            try:
                if device_ingest is not None:
                    # device-direct order: the index write first (device
                    # work, issued without waiting), then drain the f16 store
                    # rows, whose copy overlaps the write
                    chunks, drain = device_ingest
                    self.index.add_batch_device(ids, chunks)
                    arr = drain()
                    if arr.shape[1] != dim:
                        raise InvalidArgumentError(
                            f"embedder dim {arr.shape[1]} != {dim}")
                    for d, row in zip(docs, arr):
                        d.vector = row
                    records = [DocumentRecord.from_document(d) for d in docs]
                    self.store.batch_insert(records)
                else:
                    records = [DocumentRecord.from_document(d) for d in docs]
                    self.store.batch_insert(records)
                    vecs = (embedded_all if embedded_all is not None
                            else _stack_vectors(docs, dim))
                    self.index.add_batch(ids, vecs)
                self.filter_engine.index_documents(
                    (d.id, d.metadata) for d in docs)
            except BaseException as e:
                err = e
            try:
                sparse_fut.result()
            except BaseException as e:
                if err is None:
                    err = e
            if err is not None:
                raise err
            self.engine.invalidate_cache()
            self.metrics.record_insert(len(docs))
            return ids

    def add_documents_pipelined(self, docs: Sequence[Document],
                                batch_size: int = 4096,
                                inflight: int = 2) -> List[str]:
        """Bulk ingest with overlapped batches.

        ``batch_add_documents`` embeds (featurize, device step, the f16
        store copy) before taking the write lock, so ``inflight``
        concurrent calls pipeline legally: batch N's copy and drain overlap
        batch N+1's host featurization while the lock serializes the
        index/store/filter phase.

        Semantics match sequential ``batch_add_documents`` per batch; ids
        return in input order. Batches are independent — ingest order
        BETWEEN overlapping batches is not defined, so duplicate ids across
        batches should be avoided (within a batch they raise as before).

        Reference: embeddings.rs:55-219 awaits its HTTP embedding call
        before storage per batch — it cannot overlap.
        """
        if inflight < 1 or batch_size < 1:
            raise InvalidArgumentError("inflight and batch_size must be >= 1")
        batches = [docs[i:i + batch_size]
                   for i in range(0, len(docs), batch_size)]
        if not batches:
            return []
        if inflight == 1 or len(batches) == 1:
            return [i for b in batches for i in self.batch_add_documents(b)]
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=inflight) as ex:
            results = list(ex.map(self.batch_add_documents, batches))
        return [i for ids in results for i in ids]

    # -- point ops ----------------------------------------------------------------

    def list_documents(self, offset: int = 0, limit: int = 100,
                       filter: Optional[Any] = None) -> List[Document]:
        """Paginated listing, optionally filtered (the scroll/list surface the
        reference exposes through its store pagination)."""
        if filter is not None and not filter.is_empty():
            allowed = sorted(self.filter_engine.execute_filter(filter))
            ids = allowed[offset:offset + limit]
            recs = [self.store.get(i) for i in ids]
            return [r.to_document() for r in recs if r is not None]
        return [r.to_document() for r in self.store.list_page(offset, limit)]

    def count_documents(self, filter: Optional[Any] = None) -> int:
        if filter is not None and not filter.is_empty():
            return len(self.filter_engine.execute_filter(filter))
        return self.store.count()

    def get_document(self, id_: str) -> Optional[Document]:
        rec = self.store.get(id_)
        return rec.to_document() if rec else None

    def delete_document(self, id_: str) -> bool:
        return self.batch_delete_documents([id_]) == 1

    def batch_delete_documents(self, ids: Sequence[str]) -> int:
        with self._lock:
            # Fixed order: index first, then storage (lib.rs:380-390).
            self.index.remove_batch(ids)
            for i in ids:
                self.sparse.remove_document(i)
                self.filter_engine.remove_document(i)
            n = self.store.batch_delete(ids)
            self.engine.invalidate_cache()
            self.metrics.record_delete(n)
            return n

    # -- search ---------------------------------------------------------------------

    def search(self, req: SearchRequest) -> List[SearchResult]:
        if req.vector is None and req.query:
            req.vector = self.embedder.generate_embedding(req.query)
        return self.engine.search(req)

    def vector_search(self, req: SearchRequest) -> List[ScoredPoint]:
        return self.engine.vector_search(req)

    def text_search(self, req: SearchRequest) -> List[SearchResult]:
        return self.engine.text_search(req)

    def hybrid_search(self, req: HybridSearchRequest) -> List[SearchResult]:
        if req.dense_vector is None and req.query:
            req.dense_vector = self.embedder.generate_embedding(req.query)
        return self.engine.hybrid_search(req)

    def search_documents(self, query: str, limit: int = 10) -> List[SearchResult]:
        """Semantic search with text fallback (lib.rs:459-540): embed the query,
        dense-search, and if nothing comes back fall back to the text scan."""
        vec = self.embedder.generate_embedding(query)
        results = self.engine.search(SearchRequest(query=query, vector=vec, limit=limit))
        if not results:
            results = self.engine.text_search(SearchRequest(query=query, limit=limit))
        return results

    def vector_search_batch(self, vectors: np.ndarray, limit: int) -> List[List[ScoredPoint]]:
        return self.engine.vector_search_batch(vectors, limit)

    # -- maintenance ----------------------------------------------------------------

    def rebuild_index(self) -> int:
        """Re-read all docs and rebuild device/sparse/filter state (lib.rs:560-581).
        The BM25 index takes every document in one ``add_documents`` batch
        (the ingest path's form; the reference adds them one at a time,
        which was most of a reopen's time at 131,072 documents)."""
        with self._lock:
            self.index.clear()
            self.sparse.clear()
            self.filter_engine.clear()
            ids: List[str] = []
            vecs: List[List[float]] = []
            all_ids: List[str] = []
            texts: List[str] = []
            for rec in self.store.iter_records():
                if rec.embedding is not None:
                    ids.append(rec.id)
                    vecs.append(rec.embedding)
                all_ids.append(rec.id)
                texts.append(f"{rec.title} {rec.content}".strip())
                self.filter_engine.index_document(rec.id, rec.metadata)
            self.sparse.add_documents(all_ids, texts)
            if ids:
                arr = np.asarray(vecs, dtype=np.float32)
                for i in range(0, len(ids), 8192):
                    self.index.add_batch(ids[i:i + 8192], arr[i:i + 8192])
            self.engine.invalidate_cache()
            return len(ids)

    def optimize(self) -> None:
        self.index.optimize()

    def tune(self, target_recall: float = 0.95, k: int = 10,
             queries: Optional[np.ndarray] = None, hard: bool = False,
             max_host_rescore: int = 64) -> dict:
        """Tune the index's recall/speed knob for a recall target on this
        corpus and pin the search path to it. IVF kinds sweep nprobe, the
        binary two-stage kind its rescore budget (``tune_rescore``); exact
        kinds have nothing to tune.

        - default (``hard=False``, no ``queries``): the self-recall protocol,
          validation queries are corpus rows (``tune_nprobe``). The easy
          bound: a row's neighbours concentrate in its own list.
        - ``hard=True`` or explicit held-out ``queries``: sweeps nprobe x
          host_rescore against an exhaustive-probe + exact-host-rescore
          oracle, on held-out queries synthesized from the cluster
          distribution when none are given (``synth_tuning_queries``), and
          pins ``index.nprobe`` and ``config.query.host_rescore``.
        """
        out: dict = {"kind": self.index.kind}
        tune_np = getattr(self.index, "tune_nprobe", None)
        tune_rs = getattr(self.index, "tune_rescore", None)
        if tune_np is not None:
            if hard or queries is not None:
                out.update(self._tune_hard(queries, k, target_recall, max_host_rescore))
            else:
                out["nprobe"] = tune_np(k=k, target_recall=target_recall)
        elif tune_rs is not None and getattr(self.index, "keep_vectors", False):
            out["rescore_budget"] = tune_rs(k=k, target_recall=target_recall)
        self.engine.invalidate_cache()
        return out

    def synth_tuning_queries(self, n: int = 128, seed: int = 0) -> np.ndarray:
        """Held-out tuning queries from the cluster distribution: midpoints
        of stored pairs that share a list, on the data manifold but not
        corpus rows, whose true neighbours spread over adjacent lists."""
        rng = np.random.default_rng(seed)
        cell = getattr(self.index, "_id_to_cell", None)
        dim = self.config.vector_dimension
        if not cell:
            raise InvalidArgumentError(
                "synth_tuning_queries needs a trained IVF-family index")
        ids = list(cell)
        # sample enough ids that ~n same-list pairs appear by birthday
        # collision (m^2 / 2L >= n) without walking the whole id map
        nlist = getattr(self.index, "nlist", 1)
        m = min(len(ids), int(np.sqrt(2.0 * nlist * n)) + 4 * n)
        sample = rng.choice(len(ids), size=m, replace=False)
        by_list: Dict[int, List[str]] = {}
        for si in sample:
            id_ = ids[si]
            by_list.setdefault(cell[id_][0], []).append(id_)
        pairs: List[Tuple[str, str]] = []
        for members in by_list.values():
            rng.shuffle(members)
            for a, b in zip(members[::2], members[1::2]):
                pairs.append((a, b))
        if not pairs:
            raise InvalidArgumentError(
                "not enough same-list pairs to synthesize queries — pass "
                "held-out queries explicitly")
        take = [pairs[i % len(pairs)] for i in range(n)]
        qs = np.empty((n, dim), np.float32)
        for i, (a, b) in enumerate(take):
            ra, rb = self.store.get(a), self.store.get(b)
            if ra is None or ra.embedding is None or rb is None or rb.embedding is None:
                va = self.index.get_vector(a)
                vb = self.index.get_vector(b)
            else:
                va = np.asarray(ra.embedding, np.float32)
                vb = np.asarray(rb.embedding, np.float32)
            qs[i] = 0.5 * (va + vb)
        return qs

    def _tune_hard(self, queries: Optional[np.ndarray], k: int,
                   target_recall: float, max_host_rescore: int) -> dict:
        """Joint (nprobe, host_rescore) sweep against this index's best
        reachable answer (the exhaustive tier over every valid cell, with the
        store's full-precision rescore) on held-out queries. Pins
        index.nprobe and config.query.host_rescore."""
        idx = self.index
        if queries is None:
            queries = self.synth_tuning_queries(n=128)
        queries = np.asarray(queries, dtype=np.float32)
        # host rescore needs full-precision rows in the store
        have_store = False
        for id_ in itertools.islice(getattr(idx, "_id_to_cell", {}), 1):
            rec = self.store.get(id_)
            have_store = rec is not None and rec.embedding is not None
        rescore_grid = [0, max_host_rescore] if (
            have_store and max_host_rescore > k) else [0]
        # one fetch width for the whole sweep: a fetch-`max` row truncated
        # to k equals a fetch-k row
        fetch = max(k, *rescore_grid)

        def run(nprobe: int, rescore: int,
                exhaustive: bool = False) -> List[List[Tuple[str, float]]]:
            if exhaustive:
                # the exact oracle in one pass over the lists per batch
                rows = idx.search_batch(queries, fetch,
                                        mask=(idx.valid.cpu().numpy(), None),
                                        exhaustive=True)
            else:
                rows = idx.search_batch(queries, fetch, nprobe=nprobe)
            if rescore:
                rows = self.engine._host_rescore_rows(queries, rows, k)
            return [row[:k] for row in rows]

        use_exh = bool(getattr(idx, "supports_exhaustive_mask", False)
                       and getattr(idx, "valid", None) is not None)
        oracle_rows = run(idx.nlist, max(rescore_grid), exhaustive=use_exh)
        oracle = [frozenset(h[0] for h in row) for row in oracle_rows]
        denom = sum(len(w) for w in oracle) or 1

        def recall_of(rows) -> float:
            return sum(len({h[0] for h in row} & want)
                       for row, want in zip(rows, oracle)) / denom

        chosen = (idx.nlist, rescore_grid[-1])
        chosen_recall = 1.0
        cand = 1
        table = []
        while cand <= idx.nlist:
            found = False
            for rescore in rescore_grid:
                rec = recall_of(run(cand, rescore))
                table.append({"nprobe": cand, "host_rescore": rescore,
                              "recall": round(rec, 4)})
                if rec >= target_recall:
                    chosen = (cand, rescore)
                    chosen_recall = rec
                    found = True
                    break
            if found or cand == idx.nlist:
                break
            cand = min(cand * 2, idx.nlist)
        idx.nprobe = chosen[0]
        self.config.query.host_rescore = chosen[1]
        return {"nprobe": chosen[0], "host_rescore": chosen[1],
                "recall": round(chosen_recall, 4), "protocol": "held_out",
                "sweep": table}

    def flush(self) -> None:
        self.store.flush()

    def close(self) -> None:
        self._closed = True
        self._sparse_pool.shutdown(wait=True)
        self.store.close()

    # -- enterprise wrappers (lib.rs:717-787) ---------------------------------------------

    def enable_enterprise(self, auth=None, resilience=None):
        """Attach auth/RBAC + resilience guards. Returns the auth manager."""
        from grape_vector_db_tpu_torch.services.enterprise import AuthenticationManager
        from grape_vector_db_tpu_torch.services.resilience import ResilienceManager

        self.auth = auth or AuthenticationManager()
        self.resilience = resilience or ResilienceManager()
        return self.auth

    def _guarded(self, credential: str, perm, fn):
        if self.auth is None:
            raise StateError("enterprise features not enabled — call enable_enterprise()")
        self.auth.authorize(credential, perm)
        return self.resilience.execute(fn)

    def search_with_auth(self, credential: str, req: SearchRequest):
        from grape_vector_db_tpu_torch.services.enterprise import Permission

        return self._guarded(credential, Permission.READ_DATA, lambda: self.search(req))

    def add_documents_with_auth(self, credential: str, docs: Sequence[Document]):
        from grape_vector_db_tpu_torch.services.enterprise import Permission

        return self._guarded(
            credential, Permission.WRITE_DATA, lambda: self.batch_add_documents(docs)
        )

    def delete_documents_with_auth(self, credential: str, ids: Sequence[str]):
        from grape_vector_db_tpu_torch.services.enterprise import Permission

        return self._guarded(
            credential, Permission.WRITE_DATA, lambda: self.batch_delete_documents(ids)
        )

    # -- backup / stats / health ---------------------------------------------------------

    def save_index(self, path: str) -> Dict[str, Any]:
        """Index snapshot (query.rs:282-409): compressed ids+vectors+metadata,
        dimension-validated on load; the JAX package's format (a zstd frame
        of msgpack, vectors as raw f32 bytes) where zstandard imports, else
        the zlib blob under its own magic (``storage/file.py``). Rebuilding
        index structures from raw vectors is cheap, so snapshotting vectors
        is the whole checkpoint."""
        ids, vecs = self.index.get_all()
        payload = packb({
            "metadata": {
                "dimension": self.config.vector_dimension,
                "total_points": len(ids),
                "created_at": int(time.time() * 1000),
                "index_kind": self.index.get_stats().kind,
                "metric": self.config.distance,
            },
            "ids": ids,
            "vectors_f32": np.ascontiguousarray(vecs, dtype=np.float32).tobytes(),
        })
        blob = compress(payload, 3)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return {"points": len(ids), "bytes": len(blob)}

    def load_index(self, path: str) -> Dict[str, Any]:
        """Load an index snapshot of either route; rejects dimension
        mismatches (query.rs:282-409)."""
        with open(path, "rb") as f:
            payload = unpackb(decompress(f.read()))
        meta = payload["metadata"]
        if meta["dimension"] != self.config.vector_dimension:
            raise InvalidArgumentError(
                f"index snapshot dimension {meta['dimension']} != "
                f"configured {self.config.vector_dimension}"
            )
        ids = payload["ids"]
        # a writable copy: torch.from_numpy takes no read-only buffer
        vecs = np.frombuffer(bytearray(payload["vectors_f32"]), dtype=np.float32).reshape(
            len(ids), meta["dimension"]
        )
        with self._lock:
            self.index.clear()
            for s in range(0, len(ids), 8192):
                self.index.add_batch(ids[s:s + 8192], vecs[s:s + 8192])
            self.index.optimize()
            self.engine.invalidate_cache()
        return {"points": len(ids), "created_at": meta["created_at"]}

    def create_backup(self, backup_path: str) -> Dict[str, Any]:
        return self.store.create_backup(backup_path)

    def restore_backup(self, backup_path: str) -> Dict[str, Any]:
        with self._lock:
            info = self.store.restore_backup(backup_path)
            self.rebuild_index()
            return info

    # -- stats / health -------------------------------------------------------------

    def stats(self) -> DatabaseStats:
        idx = self.index.get_stats()
        st = self.store.get_stats()
        m = self.metrics.snapshot()
        return DatabaseStats(
            document_count=st.document_count,
            index_size=idx.point_count,
            index_kind=idx.kind,
            index_memory_mb=idx.memory_usage_mb,
            storage_size_bytes=st.estimated_size_bytes,
            sparse_vocabulary=self.sparse.vocabulary_size(),
            cache_hit_rate=m.cache_hit_rate,
            uptime_s=time.monotonic() - self._t0,
            extra={"qps": m.qps, "p95_ms": m.p95_latency_ms},
        )

    def health_check(self) -> Dict[str, Any]:
        storage_ok = self.store.health_check()
        index_ok = len(self.index) == sum(
            1 for r in self.store.iter_records() if r.embedding is not None
        )
        return {
            "status": "healthy" if storage_ok else "unhealthy",
            "storage": storage_ok,
            "index_consistent": index_ok,
            "document_count": self.store.count(),
            "index_count": len(self.index),
        }

"""EmbeddedVectorDB — in-process mode with full lifecycle management.

Rebuilds the reference's embedded mode (src/embedded.rs): the single-process
deployment — one host plus its TPU chips — with a blocking API, a lifecycle
state machine (Initializing/Ready/Busy/ShuttingDown/Closed, embedded.rs:22-29,
460-473), warmup (embedded.rs:436-458 — here: device jit warm + store page
touch), a LifecycleManager with shutdown hooks (embedded.rs:106-178), a
background HealthChecker (30s default), and graceful close that waits for
pending operations, flushes, and runs hooks (embedded.rs:595-702).

Async variants (``*_async``) run the blocking core on a thread pool — the
Python analog of the reference's owned tokio runtime (embedded.rs:204-213).
"""

from __future__ import annotations

import asyncio
import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from grape_vector_db_tpu_torch.config import EmbeddedConfig
from grape_vector_db_tpu_torch.db import DatabaseStats, VectorDatabase
from grape_vector_db_tpu_torch.errors import StateError, TimeoutError_
from grape_vector_db_tpu_torch.types import (
    Document,
    HybridSearchRequest,
    ScoredPoint,
    SearchRequest,
    SearchResult,
)

__all__ = ["DbState", "CheckStatus", "CheckResult", "EmbeddedVectorDB"]


class DbState(enum.Enum):
    INITIALIZING = "initializing"
    READY = "ready"
    BUSY = "busy"
    SHUTTING_DOWN = "shutting_down"
    CLOSED = "closed"


class CheckStatus(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY = "unhealthy"


@dataclass
class CheckResult:
    status: CheckStatus
    checks: Dict[str, bool] = field(default_factory=dict)
    message: str = ""
    timestamp: float = field(default_factory=time.time)


class _LifecycleManager:
    """Shutdown hooks + state transitions (embedded.rs:106-178)."""

    def __init__(self) -> None:
        self._hooks: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def add_shutdown_hook(self, hook: Callable[[], None]) -> None:
        with self._lock:
            self._hooks.append(hook)

    def run_shutdown_hooks(self) -> List[Exception]:
        errors: List[Exception] = []
        with self._lock:
            hooks = list(self._hooks)
        for h in hooks:
            try:
                h()
            except Exception as e:  # hooks must not block shutdown
                errors.append(e)
        return errors


class EmbeddedVectorDB:
    """Blocking in-process vector DB (embedded.rs EmbeddedVectorDB)."""

    def __init__(self, config: Optional[EmbeddedConfig] = None, **db_kwargs: Any):
        self.config = config or EmbeddedConfig()
        self._state = DbState.INITIALIZING
        self._state_lock = threading.Lock()
        self._pending_ops = 0
        self._pending_cv = threading.Condition()
        self.lifecycle = _LifecycleManager()
        self._health_thread: Optional[threading.Thread] = None
        self._stop_health = threading.Event()
        self._last_health: Optional[CheckResult] = None

        t0 = time.monotonic()
        self.db = VectorDatabase(
            path=self.config.data_dir, config=self.config.db, **db_kwargs
        )
        # Micro-batching executor: packs concurrent single-query calls into one
        # device batch (services/concurrent.py; the TPU analog of the
        # reference's rayon parallel search).
        from grape_vector_db_tpu_torch.services.concurrent import BatchingExecutor

        self.executor = BatchingExecutor(
            self.db.engine.vector_search_batch,
            max_batch=self.config.db.device.max_query_batch,
        )
        if self.config.enable_warmup:
            self.warmup()
        if time.monotonic() - t0 > self.config.startup_timeout_s:
            raise TimeoutError_("startup exceeded configured timeout")
        self._set_state(DbState.READY)
        self._start_health_checker()

    # -- lifecycle -----------------------------------------------------------------

    def _set_state(self, s: DbState) -> None:
        with self._state_lock:
            self._state = s

    @property
    def state(self) -> DbState:
        return self._state

    def _ensure_ready(self) -> None:
        """embedded.rs:461-473 ensure_ready."""
        if self._state not in (DbState.READY, DbState.BUSY):
            raise StateError(f"database not ready (state={self._state.value})")

    def warmup(self) -> None:
        """4-phase warmup analog (advanced_storage.rs:361-496): (1) touch store
        pages, (2) trigger jit compilation of the search kernel with a dummy
        query, (3) prime the sparse index stats, (4) prime the result cache path."""
        self.db.store.list_page(0, 2000)
        dim = self.db.config.vector_dimension
        if len(self.db.index):
            self.db.index.search_batch(np.zeros((1, dim), dtype=np.float32), 10)
        self.db.sparse.get_stats()
        self.db.engine.cache_stats()

    def _start_health_checker(self) -> None:
        interval = self.config.health_check_interval_s
        if interval <= 0:
            return

        def loop() -> None:
            while not self._stop_health.wait(interval):
                try:
                    self._last_health = self.health_check()
                except Exception:
                    pass

        self._health_thread = threading.Thread(target=loop, daemon=True, name="gvdb-health")
        self._health_thread.start()

    def close(self) -> None:
        """Graceful close (embedded.rs:595-702): drain pending ops, flush,
        run shutdown hooks, stop background threads."""
        if self._state == DbState.CLOSED:
            return
        self._set_state(DbState.SHUTTING_DOWN)
        deadline = time.monotonic() + self.config.shutdown_timeout_s
        with self._pending_cv:
            while self._pending_ops > 0 and time.monotonic() < deadline:
                self._pending_cv.wait(timeout=0.1)
        self._stop_health.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2.0)
        self.executor.close()
        self.db.flush()
        self.db.close()
        self.lifecycle.run_shutdown_hooks()
        self._set_state(DbState.CLOSED)

    def __enter__(self) -> "EmbeddedVectorDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- op tracking ------------------------------------------------------------------

    def _begin_op(self) -> None:
        self._ensure_ready()
        with self._pending_cv:
            self._pending_ops += 1

    def _end_op(self) -> None:
        with self._pending_cv:
            self._pending_ops -= 1
            self._pending_cv.notify_all()

    def _run(self, fn: Callable[[], Any]) -> Any:
        self._begin_op()
        try:
            return fn()
        finally:
            self._end_op()

    # -- blocking API (embedded.rs:292-339) ----------------------------------------------

    def upsert(self, docs: Sequence[Document]) -> List[str]:
        return self._run(lambda: self.db.batch_add_documents(list(docs)))

    def upsert_one(self, doc: Document) -> str:
        return self.upsert([doc])[0]

    def search(self, req: SearchRequest) -> List[SearchResult]:
        return self._run(lambda: self.db.search(req))

    def vector_search(self, req: SearchRequest) -> List[ScoredPoint]:
        return self._run(lambda: self.db.vector_search(req))

    def vector_search_one(self, vector, k: int = 10) -> List[ScoredPoint]:
        """Single-query fast path through the micro-batching executor:
        concurrent callers share one device batch."""
        self._ensure_ready()
        return self.executor.search(np.asarray(vector, dtype=np.float32), k)

    def hybrid_search(self, req: HybridSearchRequest) -> List[SearchResult]:
        return self._run(lambda: self.db.hybrid_search(req))

    def get(self, id_: str) -> Optional[Document]:
        return self._run(lambda: self.db.get_document(id_))

    def delete(self, ids: Sequence[str]) -> int:
        return self._run(lambda: self.db.batch_delete_documents(list(ids)))

    def stats(self) -> DatabaseStats:
        return self.db.stats()

    # -- async facade -----------------------------------------------------------------------

    async def upsert_async(self, docs: Sequence[Document]) -> List[str]:
        return await asyncio.to_thread(self.upsert, docs)

    async def search_async(self, req: SearchRequest) -> List[SearchResult]:
        return await asyncio.to_thread(self.search, req)

    async def vector_search_async(self, req: SearchRequest) -> List[ScoredPoint]:
        return await asyncio.to_thread(self.vector_search, req)

    async def hybrid_search_async(self, req: HybridSearchRequest) -> List[SearchResult]:
        return await asyncio.to_thread(self.hybrid_search, req)

    async def delete_async(self, ids: Sequence[str]) -> int:
        return await asyncio.to_thread(self.delete, ids)

    # -- health (embedded.rs:355-419) ----------------------------------------------------------

    def health_check(self) -> CheckResult:
        checks: Dict[str, bool] = {}
        checks["state_ready"] = self._state in (DbState.READY, DbState.BUSY)
        try:
            h = self.db.health_check()
            checks["storage"] = bool(h["storage"])
            checks["index_consistent"] = bool(h["index_consistent"])
        except Exception:
            checks["storage"] = False
            checks["index_consistent"] = False
        ok = sum(checks.values())
        if ok == len(checks):
            status = CheckStatus.HEALTHY
        elif checks.get("storage"):
            status = CheckStatus.DEGRADED
        else:
            status = CheckStatus.UNHEALTHY
        return CheckResult(status=status, checks=checks)

    @property
    def last_health(self) -> Optional[CheckResult]:
        return self._last_health

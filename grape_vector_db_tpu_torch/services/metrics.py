"""Metrics collection (reference src/metrics.rs).

``MetricsCollector``: sliding-window query latencies (10k samples) with
p50/p95/p99 (metrics.rs:47-86), hit/miss counters, a 60s-window QPS calculator
(metrics.rs:127-159), and named gauges. ``QueryTimer`` is the RAII timer
(metrics.rs:468-488) — a context manager here. A Prometheus text exposition
endpoint (same ``grape_vector_db_*`` metric names, metrics.rs:352-402) renders
from this collector in the server layer.

Port addition: always-on counters read from the objects that do the work
(``add_counters``; an index's lock wait and device milliseconds, from a pair
of CUDA events around each call) and the garbage collector's pauses by
generation (``utils/tracing.py``), rendered beside the reference's metrics.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from grape_vector_db_tpu_torch.utils.tracing import gc_pause_seconds

__all__ = ["PerformanceMetrics", "MetricsCollector", "QueryTimer"]


@dataclass
class PerformanceMetrics:
    """metrics.rs:13-44 PerformanceMetrics snapshot."""

    total_queries: int = 0
    successful_queries: int = 0
    failed_queries: int = 0
    avg_latency_ms: float = 0.0
    p50_latency_ms: float = 0.0
    p95_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    max_latency_ms: float = 0.0
    qps: float = 0.0
    cache_hit_rate: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    insert_count: int = 0
    delete_count: int = 0
    device_time_ms_total: float = 0.0
    gauges: Dict[str, float] = field(default_factory=dict)


class MetricsCollector:
    def __init__(self, window_size: int = 10_000, qps_window_s: float = 60.0):
        self._lock = threading.Lock()
        self._latencies: Deque[float] = deque(maxlen=window_size)
        self._query_times: Deque[float] = deque()
        self._qps_window_s = qps_window_s
        self._total = 0
        self._ok = 0
        self._fail = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._inserts = 0
        self._deletes = 0
        self._gauges: Dict[str, float] = {}
        self._counters: List[Callable[[], Dict[str, float]]] = []

    # -- recording ----------------------------------------------------------

    def record_query(self, latency_ms: float, success: bool = True) -> None:
        now = time.monotonic()
        with self._lock:
            self._latencies.append(latency_ms)
            self._query_times.append(now)
            self._trim(now)
            self._total += 1
            if success:
                self._ok += 1
            else:
                self._fail += 1

    def record_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._cache_hits += 1
            else:
                self._cache_misses += 1

    def record_insert(self, n: int = 1) -> None:
        with self._lock:
            self._inserts += n

    def record_delete(self, n: int = 1) -> None:
        with self._lock:
            self._deletes += n

    def add_counters(self, read: Callable[[], Dict[str, float]]) -> None:
        """Export the always-on counters ``read()`` returns (name -> value),
        read afresh at each snapshot and summed by name over the sources."""
        with self._lock:
            self._counters.append(read)

    def counters(self) -> Dict[str, float]:
        """The sources' counters, and the collector's pause seconds by
        generation as ``gc_pause_seconds_total{generation="<g>"}``."""
        with self._lock:
            sources = list(self._counters)
        out: Dict[str, float] = {}
        for read in sources:
            for name, val in read().items():
                out[name] = out.get(name, 0.0) + val
        for gen, secs in enumerate(gc_pause_seconds()):
            out[f'gc_pause_seconds_total{{generation="{gen}"}}'] = secs
        return out

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def record_hbm(self) -> None:
        """Sample device memory occupancy into gauges (SURVEY §2.2 metrics
        row: HBM gauge). The CUDA caching allocator reports bytes in use via
        ``torch.cuda.memory_stats()`` and the card its total memory; a
        process that never touched CUDA (CPU devices) is a no-op — sampling
        must not initialize a CUDA context. Called by snapshot(), so
        /metrics always carries a fresh sample."""
        import torch

        if not torch.cuda.is_initialized():
            return
        stats = torch.cuda.memory_stats()
        used = stats.get("allocated_bytes.all.current")
        limit = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
        with self._lock:
            if used is not None:
                self._gauges["hbm_bytes_in_use"] = float(used)
            if limit:
                self._gauges["hbm_bytes_limit"] = float(limit)
                if used is not None:
                    self._gauges["hbm_occupancy"] = float(used) / float(limit)

    def _trim(self, now: float) -> None:
        cutoff = now - self._qps_window_s
        while self._query_times and self._query_times[0] < cutoff:
            self._query_times.popleft()

    # -- reading --------------------------------------------------------------

    @staticmethod
    def _percentile(sorted_vals, q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
        return sorted_vals[idx]

    def snapshot(self) -> PerformanceMetrics:
        self.record_hbm()
        device_ms = self.counters().get("device_time_ms_total", 0.0)
        with self._lock:
            lats = sorted(self._latencies)
            self._trim(time.monotonic())
            qps = len(self._query_times) / self._qps_window_s
            hits, misses = self._cache_hits, self._cache_misses
            return PerformanceMetrics(
                total_queries=self._total,
                successful_queries=self._ok,
                failed_queries=self._fail,
                avg_latency_ms=(sum(lats) / len(lats)) if lats else 0.0,
                p50_latency_ms=self._percentile(lats, 0.50),
                p95_latency_ms=self._percentile(lats, 0.95),
                p99_latency_ms=self._percentile(lats, 0.99),
                max_latency_ms=lats[-1] if lats else 0.0,
                qps=qps,
                cache_hit_rate=hits / (hits + misses) if (hits + misses) else 0.0,
                cache_hits=hits,
                cache_misses=misses,
                insert_count=self._inserts,
                delete_count=self._deletes,
                device_time_ms_total=device_ms,
                gauges=dict(self._gauges),
            )

    def prometheus_text(self, prefix: str = "grape_vector_db") -> str:
        """Prometheus text exposition (same metric names as metrics.rs:352-402)."""
        m = self.snapshot()
        lines = []
        pairs: Tuple[Tuple[str, float], ...] = (
            ("queries_total", m.total_queries),
            ("queries_success_total", m.successful_queries),
            ("queries_failed_total", m.failed_queries),
            ("query_latency_ms_avg", m.avg_latency_ms),
            ("query_latency_ms_p50", m.p50_latency_ms),
            ("query_latency_ms_p95", m.p95_latency_ms),
            ("query_latency_ms_p99", m.p99_latency_ms),
            ("qps", m.qps),
            ("cache_hit_rate", m.cache_hit_rate),
            ("inserts_total", m.insert_count),
            ("deletes_total", m.delete_count),
            ("device_time_ms_total", m.device_time_ms_total),
        )
        for name, val in pairs:
            lines.append(f"{prefix}_{name} {val}")
        for g, val in m.gauges.items():
            lines.append(f"{prefix}_{g} {val}")
        for name, val in self.counters().items():
            if name != "device_time_ms_total":
                lines.append(f"{prefix}_{name} {val}")
        return "\n".join(lines) + "\n"


class QueryTimer:
    """RAII query timer (metrics.rs:468-488) as a context manager."""

    def __init__(self, collector: Optional[MetricsCollector]):
        self.collector = collector
        self.latency_ms: float = 0.0
        self._ok = True

    def fail(self) -> None:
        self._ok = False

    def __enter__(self) -> "QueryTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.latency_ms = (time.perf_counter() - self._t0) * 1e3
        if self.collector is not None:
            self.collector.record_query(self.latency_ms, success=self._ok and exc_type is None)

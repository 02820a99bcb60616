"""Benchmark / evaluation harness (reference src/benchmark.rs)."""

from grape_vector_db_tpu_torch.bench.suite import (
    BenchmarkConfig,
    BenchmarkResult,
    BenchmarkSuite,
    ndcg_at_k,
)

__all__ = ["BenchmarkConfig", "BenchmarkResult", "BenchmarkSuite", "ndcg_at_k"]

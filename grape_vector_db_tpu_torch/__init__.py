"""grape_vector_db_tpu_torch — the PyTorch + CUDA port of grape_vector_db_tpu.

The JAX package beside it is the reference; this package keeps its module
paths and public names so each module's counterpart is easy to find. It
imports ``torch`` and numpy and never JAX. Device arrays live on an explicit
``device`` (default ``"cuda"``); the CPU tests pass ``device="cpu"``.

Ported so far: ``VectorDatabase`` over the memory or the file store
(``path``), with every single-chip index kind: the exact flat index, whose
large-corpus search runs the hand-written segment top-k CUDA kernels
(``ops/segmax.py``; ``csrc/segmax_max.cu`` in bf16 storage,
``csrc/segmax.cu`` in f32); the two-stage binary, int8 and PQ flat kinds,
whose binary popcount route runs the Hamming kernel (``ops/hamming.py``,
``csrc/hamming.cu``); the IVF family (bf16, int8, int4, PQ and the projected
int8/int4 kinds), whose probes run the ragged probe kernels (``ops/ivf.py``,
``csrc/ivf_probe.cu``); and graph search, whose build and beam run the
gather-dot kernel (``ops/graph.py``, ``csrc/gather.cu``). The embedded
deployment (``EmbeddedVectorDB``: lifecycle, warmup, health checks, the
micro-batching executor, async variants) runs over it, with index
snapshots, backups, the enterprise wrappers and the device hash embedder
(``services/device_embedder.py``, the JAX package's projection bit for bit).
The sharded kinds (``parallel``) split one index over a mesh of devices
that this process drives; the distributed tier (``distributed``) runs a
cluster of nodes. ROADMAP.md lists what is still to be ported.
"""

from grape_vector_db_tpu_torch.config import (
    EmbeddedConfig,
    VectorDbConfig,
    load_config,
)
from grape_vector_db_tpu_torch.db import DatabaseStats, VectorDatabase
from grape_vector_db_tpu_torch.embedded import CheckResult, CheckStatus, DbState, EmbeddedVectorDB
from grape_vector_db_tpu_torch.errors import VectorDbError
from grape_vector_db_tpu_torch.types import (
    Condition,
    Document,
    Filter,
    FusionStrategy,
    FusionWeights,
    HybridSearchRequest,
    Point,
    ScoredPoint,
    SearchParams,
    SearchRequest,
    SearchResult,
    SparseVector,
)

__version__ = "0.1.0"

__all__ = [
    "VectorDatabase",
    "EmbeddedVectorDB",
    "DatabaseStats",
    "VectorDbConfig",
    "EmbeddedConfig",
    "load_config",
    "Document",
    "Point",
    "SparseVector",
    "SearchParams",
    "SearchRequest",
    "SearchResult",
    "ScoredPoint",
    "HybridSearchRequest",
    "FusionStrategy",
    "FusionWeights",
    "Filter",
    "Condition",
    "VectorDbError",
    "DbState",
    "CheckStatus",
    "CheckResult",
    "__version__",
]

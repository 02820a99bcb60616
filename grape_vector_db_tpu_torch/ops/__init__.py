"""Device ops in PyTorch: distance scoring + top-k (``distance``), the
segment top-k kernels of the large-corpus exact engine (``segmax``), the
binary prescans and the Hamming kernel (``hamming``), int8 / int4 / PQ
quantization and scans (``int8``, ``int4``, ``pq``), k-means, the IVF
probe kernels and filter tiers (``ivf``, ``ivf_scan``), and graph search
(``graph``) with its candidate gather-dot kernel (``gather``) and the
tie-ordered top-k (``topk``)."""

from grape_vector_db_tpu_torch.ops.distance import (
    l2_normalize,
    prepare_queries,
    score_block,
    scored_topk,
)
from grape_vector_db_tpu_torch.ops.segmax import segmax2_topk, segmax4_topk, segmax_topk

__all__ = ["l2_normalize", "prepare_queries", "score_block", "scored_topk",
           "segmax_topk", "segmax4_topk", "segmax2_topk"]

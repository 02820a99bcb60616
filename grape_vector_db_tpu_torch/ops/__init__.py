"""Device ops in PyTorch: distance scoring + top-k (``distance``) and the
segment top-k kernels of the large-corpus exact engine (``segmax``)."""

from grape_vector_db_tpu_torch.ops.distance import (
    l2_normalize,
    prepare_queries,
    score_block,
    scored_topk,
)

__all__ = ["l2_normalize", "prepare_queries", "score_block", "scored_topk"]

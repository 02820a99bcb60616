"""Device ops in PyTorch: distance scoring + top-k (``distance``), the
segment top-k kernels of the large-corpus exact engine (``segmax``), the
binary prescans and their asym and Hamming kernels (``hamming``), int8 / int4 / PQ
quantization and scans (``int8``, ``int4``, ``pq``), k-means, the IVF
probe kernels and filter tiers (``ivf``, ``ivf_scan``), and graph search
(``graph``) with its candidate gather-dot kernel (``gather``) and the
tie-ordered top-k (``topk``). The names the reference's ``ops`` package
exports are exported here too, with the segment-max entry points."""

from grape_vector_db_tpu_torch.ops.distance import (
    l2_normalize,
    prepare_queries,
    score_block,
    scored_topk,
)
from grape_vector_db_tpu_torch.ops.graph import beam_search, build_knn_graph
from grape_vector_db_tpu_torch.ops.hamming import (
    asym_topk,
    hamming_scores,
    hamming_topk,
    pack_bits,
    words_per_vector,
)
from grape_vector_db_tpu_torch.ops.kmeans import assign_clusters, kmeans
from grape_vector_db_tpu_torch.ops.pq import adc_topk, encode_pq, train_pq
from grape_vector_db_tpu_torch.ops.segmax import segmax2_topk, segmax4_topk, segmax_topk
from grape_vector_db_tpu_torch.ops.topk import merge_topk, take_topk

__all__ = ["l2_normalize", "prepare_queries", "scored_topk", "score_block",
           "merge_topk", "take_topk", "asym_topk", "pack_bits", "hamming_scores",
           "hamming_topk", "words_per_vector", "kmeans", "assign_clusters",
           "build_knn_graph", "beam_search", "train_pq", "encode_pq", "adc_topk",
           "segmax_topk", "segmax4_topk", "segmax2_topk"]

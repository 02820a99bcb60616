"""Reference of ``kind="ivf"``: judged as VectorDBBench and ann-benchmarks
judge an approximate index, by its recall of the exact top k.

What the configuration guarantees: each answer is a stored row carrying its
cosine over the rows as stored (bf16), in f32, and the answers find the
exact top k up to the cell's limit on ``recall_miss``. The reference works
from the corpus alone: it trains no centroids and reads nothing the index
learned, so a bad k-means shows as missed answers. ``control`` is the flat
reference's exact search in fp8, the step below bf16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.reference import common as C
from portbench.reference import flat

#: ann-benchmarks' k-NN recall counts an answer as found when its distance
#: lies within this of the k-th true distance; here the distance is
#: 1 - cosine.
RECALL_EPSILON = 1e-3


def prepare(x, config: dict) -> C.Rows:
    return C.stored_rows(x, config["db"]["device"]["storage_dtype"])


def judge(rows: C.Rows, config: dict, queries: np.ndarray, k: int, ids: np.ndarray,
          scores: np.ndarray) -> Dict[str, float]:
    """``score_gap``: the widest gap between a returned score and the
    reference's cosine of the returned row. ``bad_hits``: answers that are
    faults in themselves (``common.structure``). ``recall_miss``: the share
    of the call's B x k answers not found, where an answer is found when its
    reference cosine lies no more than ``RECALL_EPSILON`` below the k-th
    best cosine over the whole corpus; a bad answer is not found."""
    qu = C.unit_queries(queries, rows.x.device, config["db"]["device"]["storage_dtype"])
    bad = C.structure(ids, scores, rows.x.shape[0], k)
    ref, gap = C.score_gaps(qu, rows, ids, scores, bad)
    kth = flat.exact_topk(qu, rows, k)[0][:, k - 1].cpu().numpy().astype(np.float64)
    found = ~bad & (ref >= kth[:, None] - RECALL_EPSILON)
    return {"score_gap": float(gap.max()), "bad_hits": int(bad.sum()),
            "recall_miss": 1.0 - float(found.sum()) / found.size}


def control(rows: C.Rows, config: dict, queries: np.ndarray,
            k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The exact search with the rows and the unit queries in scaled fp8."""
    return flat.control(rows, config, queries, k)

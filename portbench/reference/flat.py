"""Reference of ``kind="flat"``: the exact cosine top-k over every stored row.

What the configuration guarantees: each answer is the k stored rows of
highest cosine, each with its cosine over the rows as stored (bf16), in f32.
``judge`` holds the program's answers to that; ``control`` is the same
search computed with the rows and queries in fp8, the step below bf16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import common as C


def prepare(x: torch.Tensor, config: dict) -> C.Rows:
    return C.stored_rows(x, config["db"]["device"]["storage_dtype"])


def _storage(config: dict) -> str:
    return config["db"]["device"]["storage_dtype"]


def exact_topk(qu: torch.Tensor, rows: C.Rows, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pv, pi = [], []
    n = rows.x.shape[0]
    for lo in range(0, n, C.BLOCK):
        s = C.cosine_block(qu, rows, lo, min(lo + C.BLOCK, n))
        v, i = torch.topk(s, k, dim=1)
        pv.append(v)
        pi.append(i + lo)
    return C.topk_merge(pv, pi, k)


def judge(rows: C.Rows, config: dict, queries: np.ndarray, k: int, ids: np.ndarray,
          scores: np.ndarray) -> Dict[str, float]:
    """``score_gap``: the widest gap between a returned score and the
    reference's cosine of the returned row. ``rank_gap``: by how much the
    reference's k-th best cosine exceeds the lowest cosine among the
    returned rows (0 when the returned rows are a top k). ``bad_hits``:
    answers that are faults in themselves (``common.structure``)."""
    qu = C.unit_queries(queries, rows.x.device, _storage(config))
    bad = C.structure(ids, scores, rows.x.shape[0], k)
    ref, gap = C.score_gaps(qu, rows, ids, scores, bad)
    kth = exact_topk(qu, rows, k)[0][:, k - 1].cpu().numpy().astype(np.float64)
    whole = ~bad.any(axis=1)
    low = ref.min(axis=1)
    rank = np.where(whole, kth - low, 0.0)
    return {"score_gap": float(gap.max()), "rank_gap": float(max(rank.max(), 0.0)),
            "bad_hits": int(bad.sum())}


def control(rows: C.Rows, config: dict, queries: np.ndarray,
            k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The same search with the rows and the unit queries in scaled fp8:
    (ids [B, k], scores [B, k])."""
    dev = rows.x.device
    qf = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
    q8 = C.fp8_scaled(qf / torch.clamp(torch.linalg.vector_norm(qf, dim=1, keepdim=True),
                                       min=1e-12))
    pv, pi = [], []
    n = rows.x.shape[0]
    for lo in range(0, n, C.BLOCK):
        x8 = C.fp8_scaled(rows.x[lo:lo + C.BLOCK])
        n8 = torch.clamp(torch.linalg.vector_norm(x8, dim=1), min=1e-12)
        s = torch.clamp((q8 @ x8.T) / n8[None, :], max=1.0)
        v, i = torch.topk(s, k, dim=1)
        pv.append(v)
        pi.append(i + lo)
    v, i = C.topk_merge(pv, pi, k)
    return i.cpu().numpy(), v.cpu().numpy()

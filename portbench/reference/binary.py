"""Reference of ``kind="binary"`` (two-stage, asymmetric prescan): the exact
cosine top-k over the prescan's top r rows.

The prescan scores a row by the dot of the unit query, rounded to the
storage type, with the row's signs (+1 where the stored value exceeds the
threshold, -1 elsewhere), in f32; its best r rows are rescored by their
exact cosine over the stored rows. r follows the configuration's rule
(``rescore_rows``).

What is held: every returned id lies in the prescan's top r and carries its
exact cosine, and the k returned are the best k of the top r. Two f32 sums
of the same 768 prescan terms in different orders differ by at most
n * u * sum|q_i| each (u = 2**-24), so a row counts as inside the top r
unless its prescan lies more than twice that below the r-th, and the best k
are taken over the rows that lie more than twice that above it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import common as C


def prepare(x: torch.Tensor, config: dict) -> C.Rows:
    return C.stored_rows(x, config["db"]["device"]["storage_dtype"])


def rescore_rows(config: dict, n: int, k: int) -> int:
    """r: ``max(k, floor(rescore_ratio * n))`` capped by ``max_rescore`` and
    the capacity, rounded up to 64 times a power of two."""
    ratio = float(config["db"]["index"]["rescore_ratio"])
    cap = int(config["db"]["index"]["initial_capacity"])
    while cap < n:
        cap *= int(config["db"]["device"]["growth_factor"])
    want = min(max(k, int(ratio * n)), int(config["index_attrs"]["max_rescore"]), cap)
    r = 64
    while r < max(want, k):
        r *= 2
    return r


def _signs(rows: C.Rows, lo: int, hi: int, threshold: float) -> torch.Tensor:
    return torch.where(rows.x[lo:hi].float() > threshold, 1.0, -1.0)


def _rth(q: torch.Tensor, rows: C.Rows, r: int, threshold: float) -> torch.Tensor:
    """[B] the r-th largest prescan score of each query over every row."""
    parts = []
    n = rows.x.shape[0]
    for lo in range(0, n, C.BLOCK):
        p = q @ _signs(rows, lo, min(lo + C.BLOCK, n), threshold).T
        parts.append(torch.topk(p, min(r, p.shape[1]), dim=1)[0])
    return torch.topk(torch.cat(parts, dim=1), r, dim=1)[0][:, r - 1]


def judge(rows: C.Rows, config: dict, queries: np.ndarray, k: int, ids: np.ndarray,
          scores: np.ndarray) -> Dict[str, float]:
    """``score_gap`` and ``rank_gap`` as in ``flat.judge``, with the best k
    taken over the prescan's top r; ``bad_hits`` also counts a returned row
    whose prescan lies outside the top r; ``distinct_rows`` is the number of
    rows in the union of the batch's top-r sets (the rows a rescore reads)."""
    storage = config["db"]["device"]["storage_dtype"]
    threshold = float(config["db"]["quantization"]["threshold"])
    qu = C.unit_queries(queries, rows.x.device, storage)
    n, d = rows.x.shape
    r = rescore_rows(config, n, k)
    p_r = _rth(qu, rows, r, threshold)
    band = 2.0 * d * C.F32_UNIT * qu.abs().sum(dim=1)
    pv, pi = [], []
    union = torch.zeros(n, dtype=torch.bool, device=qu.device)
    for lo in range(0, n, C.BLOCK):
        hi = min(lo + C.BLOCK, n)
        p = qu @ _signs(rows, lo, hi, threshold).T
        union[lo:hi] = (p >= p_r[:, None]).any(dim=0)
        s = torch.where(p > (p_r + band)[:, None], C.cosine_block(qu, rows, lo, hi), -np.inf)
        v, i = torch.topk(s, k, dim=1)
        pv.append(v)
        pi.append(i + lo)
    kth = C.topk_merge(pv, pi, k)[0][:, k - 1].cpu().numpy().astype(np.float64)

    bad = C.structure(ids, scores, n, k)
    safe = torch.from_numpy(np.where(bad, 0, ids)).to(qu.device)
    sig = torch.where(rows.x[safe].float() > threshold, 1.0, -1.0)     # [B, k, D]
    p_ids = torch.bmm(sig, qu[:, :, None])[:, :, 0]
    outside = (p_ids < (p_r - band)[:, None]).cpu().numpy()
    bad |= outside
    ref, gap = C.score_gaps(qu, rows, ids, scores, bad)
    whole = ~bad.any(axis=1)
    rank = np.where(whole, kth - ref.min(axis=1), 0.0)
    return {"score_gap": float(gap.max()), "rank_gap": float(max(rank.max(), 0.0)),
            "bad_hits": int(bad.sum()), "distinct_rows": int(union.sum())}


def control(rows: C.Rows, config: dict, queries: np.ndarray,
            k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The same two stages with the unit query in scaled fp8 for the prescan
    and the rescore, and the rows in scaled fp8 for the rescore."""
    threshold = float(config["db"]["quantization"]["threshold"])
    dev = rows.x.device
    qf = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
    q8 = C.fp8_scaled(qf / torch.clamp(torch.linalg.vector_norm(qf, dim=1, keepdim=True),
                                       min=1e-12))
    n = rows.x.shape[0]
    r = rescore_rows(config, n, k)
    p_r = _rth(q8, rows, r, threshold)
    pv, pi = [], []
    for lo in range(0, n, C.BLOCK):
        hi = min(lo + C.BLOCK, n)
        p = q8 @ _signs(rows, lo, hi, threshold).T
        x8 = C.fp8_scaled(rows.x[lo:hi])
        n8 = torch.clamp(torch.linalg.vector_norm(x8, dim=1), min=1e-12)
        s = torch.clamp((q8 @ x8.T) / n8[None, :], max=1.0)
        s = torch.where(p >= p_r[:, None], s, -np.inf)
        v, i = torch.topk(s, k, dim=1)
        pv.append(v)
        pi.append(i + lo)
    v, i = C.topk_merge(pv, pi, k)
    return i.cpu().numpy(), v.cpu().numpy()

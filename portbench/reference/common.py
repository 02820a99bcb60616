"""Plain PyTorch pieces the index kinds' references share.

The reference works from the generated corpus alone: it rounds the rows to
the storage type, takes their norms and scores queries in float32 with
TF32 off, a block of rows at a time so that it fits beside nothing else on
the device. It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

BLOCK = 65536
STORAGE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
F32_UNIT = 2.0 ** -24


def strict_f32() -> None:
    """Float32 products in float32: TF32 would keep about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass
class Rows:
    x: torch.Tensor       # [N, D] rows as stored (storage dtype)
    norms: torch.Tensor   # [N] f32 L2 norms of the stored rows


def stored_rows(x: torch.Tensor, storage: str) -> Rows:
    """The rows as the configuration stores them, and their f32 norms."""
    strict_f32()
    xs = x.to(STORAGE[storage])
    norms = torch.empty(xs.shape[0], dtype=torch.float32, device=xs.device)
    for lo in range(0, xs.shape[0], BLOCK):
        norms[lo:lo + BLOCK] = torch.linalg.vector_norm(xs[lo:lo + BLOCK].float(), dim=1)
    return Rows(xs, norms)


def unit_queries(q: np.ndarray, device, storage: str) -> torch.Tensor:
    """Cosine queries: L2-normalised in f32, then rounded to the storage
    type (the stored side's type), returned as f32."""
    qf = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(device)
    qn = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=1, keepdim=True), min=1e-12)
    return qn.to(STORAGE[storage]).float()


def cosine_block(qu: torch.Tensor, rows: Rows, lo: int, hi: int) -> torch.Tensor:
    """[B, hi - lo] f32 cosine of unit queries against stored rows lo..hi-1,
    clamped at 1 as the configuration's cosine is."""
    dots = qu @ rows.x[lo:hi].float().T
    return torch.clamp(dots / torch.clamp(rows.norms[lo:hi], min=1e-12)[None, :], max=1.0)


def cosine_of(qu: torch.Tensor, rows: Rows, ids: torch.Tensor) -> torch.Tensor:
    """[B, k] f32 cosine of each query against the rows ``ids`` [B, k]
    (ids must be valid row numbers)."""
    v = rows.x[ids].float()                                   # [B, k, D]
    dots = torch.bmm(v, qu[:, :, None])[:, :, 0]
    return torch.clamp(dots / torch.clamp(rows.norms[ids], min=1e-12), max=1.0)


def topk_merge(parts_v, parts_i, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    v, i = torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1)
    top, pos = torch.topk(v, k, dim=1)
    return top, torch.gather(i, 1, pos)


def fp8_scaled(t: torch.Tensor) -> torch.Tensor:
    """Rows rounded to fp8 (e4m3) with a scale a row, as f32: each row's
    largest magnitude maps to the format's largest value."""
    t = t.float()
    scale = torch.clamp(t.abs().amax(dim=1, keepdim=True), min=1e-30) / FP8_MAX
    return (t / scale).to(FP8).float() * scale


def structure(ids: np.ndarray, scores: np.ndarray, n_rows: int, k: int) -> np.ndarray:
    """[B, k] bool of answers that are faults in themselves: a missing hit,
    an id that names no stored row, a repeated id, a score that is not
    finite or that rises after a lower one."""
    bad = (ids < 0) | (ids >= n_rows) | ~np.isfinite(scores)
    for b in range(ids.shape[0]):
        row = ids[b]
        seen = set()
        for j in range(k):
            if row[j] in seen:
                bad[b, j] = True
            seen.add(int(row[j]))
            if j and scores[b, j] > scores[b, j - 1]:
                bad[b, j] = True
    return bad


def score_gaps(qu: torch.Tensor, rows: Rows, ids: np.ndarray, scores: np.ndarray,
               bad: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per answer: the reference's cosine of the returned row, and the gap
    between it and the returned score (0 where the answer is bad)."""
    safe = np.where(bad, 0, ids)
    ref = cosine_of(qu, rows, torch.from_numpy(safe).to(qu.device)).cpu().numpy()
    gap = np.where(bad, 0.0, np.abs(scores.astype(np.float64) - ref))
    return ref, gap

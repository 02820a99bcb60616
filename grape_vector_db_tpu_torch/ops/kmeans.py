"""K-means as matmul-argmax iterations.

PyTorch counterpart of ``grape_vector_db_tpu/ops/kmeans.py``: each Lloyd
iteration is one ``[N, D] x [D, K]`` f32 matmul for the assignment plus a
segment sum for the centroid update; empty clusters keep their previous
centroid. ``mode="spherical"`` (unit-norm centroids, cosine assignment) is the
variant for the cosine and dot metrics.

The initial centroids are a sample of the rows drawn with an explicit, seeded
``torch.Generator`` (on the CPU, so a seed gives the same sample on every
device). ``jax.random.choice`` cannot be reproduced in PyTorch, so the Lloyd
iterations live in ``lloyd``, which takes the initial centroids: a test gives
both engines the same start.

``assign_clusters`` chunks over rows so the ``[rows, K]`` affinity plane stays
under ``ASSIGN_MAX_ELEMS`` (1M rows x 4096 lists would be a 17 GB plane).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["kmeans", "lloyd", "assign_clusters"]

#: Largest [rows, K] f32 affinity plane one assignment chunk may hold (256 MB).
ASSIGN_MAX_ELEMS = 1 << 26


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _assign_block(x: torch.Tensor, centroids: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "spherical":
        return torch.argmax(_l2n(x) @ centroids.T, dim=-1)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)               # [N, 1]
    c2 = torch.sum(centroids * centroids, dim=-1)[None, :]     # [1, K]
    return torch.argmin(x2 - 2.0 * (x @ centroids.T) + c2, dim=-1)


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor, mode: str = "l2",
                    chunk_rows: Optional[int] = None) -> torch.Tensor:
    """[N, D] -> [N] int32 nearest-centroid ids, in row chunks.

    mode="spherical": assign by max cosine (centroids assumed unit-norm; x is
    normalized here). Required for cosine-metric IVF on near-isotropic
    high-dim data: under L2 the smallest-norm centroid captures almost every
    point."""
    x = x.to(torch.float32)
    centroids = centroids.to(device=x.device, dtype=torch.float32)
    n = x.shape[0]
    rows = chunk_rows or max(1, ASSIGN_MAX_ELEMS // max(centroids.shape[0], 1))
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    for off in range(0, n, rows):
        out[off:off + rows] = _assign_block(x[off:off + rows], centroids, mode)
    return out


def lloyd(x: torch.Tensor, centroids: torch.Tensor, iters: int = 10,
          mode: str = "l2", chunk: Optional[int] = None) -> torch.Tensor:
    """``iters`` Lloyd steps from the given initial centroids -> [K, D] f32.

    ``chunk``: accumulate the update over row chunks of this size
    (N % chunk == 0), as the reference's chunked scan does; the assignment
    itself always chunks (``assign_clusters``)."""
    x = x.to(torch.float32)
    c = centroids.to(device=x.device, dtype=torch.float32)
    n, d = x.shape
    k = c.shape[0]
    if mode == "spherical":
        x = _l2n(x)
        c = _l2n(c)
    if chunk is not None and chunk < n and n % chunk:
        raise ValueError(f"kmeans: n={n} must be a multiple of chunk={chunk}")
    step = chunk if chunk is not None and chunk < n else n
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
        for off in range(0, n, step):
            xc = x[off:off + step]
            a = assign_clusters(xc, c, mode=mode).to(torch.int64)
            sums.index_add_(0, a, xc)
            counts += torch.bincount(a, minlength=k).to(torch.float32)
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        if mode == "spherical":
            new_c = _l2n(new_c)
        # Empty clusters keep their previous centroid.
        c = torch.where((counts > 0)[:, None], new_c, c)
    return c


def kmeans(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0, mode: str = "l2",
           chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on ``x``'s device. Returns (centroids [k, D] f32,
    assignment [N] int32). x is [N, D] with N >= k."""
    n = x.shape[0]
    if n < k:
        raise ValueError(f"kmeans: need n >= k, got n={n}, k={k}")
    gen = torch.Generator().manual_seed(seed)
    init_idx = torch.randperm(n, generator=gen)[:k].to(x.device)
    centroids = lloyd(x, x[init_idx], iters=iters, mode=mode, chunk=chunk)
    return centroids, assign_clusters(x, centroids, mode=mode, chunk_rows=chunk)

"""Product quantization: per-subspace codebooks + ADC scoring.

PyTorch counterpart of ``grape_vector_db_tpu/ops/pq.py``:

- ``train_pq``: k-means per subspace (``ops/kmeans.py``), or Lloyd steps
  from given starting codebooks (``init``; ``jax.random``'s starts cannot be
  reproduced, so a test hands both engines the same ones);
- ``encode_pq``: nearest-codeword assignment per subspace -> uint8 codes
  ``[N, S]``;
- ``adc_topk``: asymmetric distance computation. Each query builds an
  ``[S, 256]`` table of subspace dot products, and a row's score sums
  ``LUT[s, code[n, s]]`` over the subspaces in order, one gather a
  subspace (the reference leaves this gather to XLA; it has no kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from grape_vector_db_tpu_torch.ops.distance import chunked_topk
from grape_vector_db_tpu_torch.ops.kmeans import kmeans, lloyd

__all__ = ["train_pq", "encode_pq", "adc_scores", "adc_topk"]

NEG_INF = float("-inf")
# [rows, S, K] f32 distance elements one encode step holds (256 MB).
_ENCODE_CHUNK_ELEMS = 1 << 26


def train_pq(
    vectors: torch.Tensor,   # [N, D] f32 training sample
    n_sub: int,
    nbits: int = 8,
    iters: int = 10,
    seed: int = 0,
    init: Optional[torch.Tensor] = None,   # [n_sub, 2^nbits, dsub] starting codebooks
) -> torch.Tensor:
    """Train per-subspace codebooks (L2 k-means on subspace s with seed
    ``seed + s``). Returns [n_sub, 2^nbits, dsub] f32."""
    n, d = vectors.shape
    if d % n_sub:
        raise ValueError(f"dim {d} must divide into {n_sub} subspaces")
    dsub = d // n_sub
    k = 2 ** nbits
    if n < k:
        raise ValueError(f"need >= {k} training vectors for {nbits}-bit PQ")
    subs = vectors.to(torch.float32).reshape(n, n_sub, dsub)
    books = []
    for s in range(n_sub):
        x = subs[:, s, :].contiguous()
        if init is None:
            cents, _ = kmeans(x, k=k, iters=iters, seed=seed + s)
        else:
            cents = lloyd(x, init[s].to(x.device), iters=iters)
        books.append(cents)
    return torch.stack(books)


def encode_pq(vectors: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """[N, D] x [S, K, dsub] -> [N, S] uint8 nearest-codeword codes (the
    first codeword on a tie), a few rows at a time."""
    n = vectors.shape[0]
    s, k, dsub = codebooks.shape
    cb = codebooks.to(torch.float32)
    c2 = torch.sum(cb * cb, dim=-1)[None]                          # [1, S, K]
    out = torch.empty((n, s), dtype=torch.uint8, device=vectors.device)
    step = max(1, _ENCODE_CHUNK_ELEMS // (s * k))
    for off in range(0, n, step):
        subs = vectors[off:off + step].to(torch.float32).reshape(-1, s, dsub)
        x2 = torch.sum(subs * subs, dim=-1)[:, :, None]            # [n, S, 1]
        xc = torch.einsum("nsd,skd->nsk", subs, cb)
        out[off:off + step] = torch.argmin(x2 - 2.0 * xc + c2, dim=-1).to(torch.uint8)
    return out


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, S, K] tables x [C, S] uint8 codes -> [B, C] f32, summed over the
    subspaces in order (the reference's scan order)."""
    b, s, _ = lut.shape
    acc = torch.zeros((b, codes.shape[0]), dtype=torch.float32, device=lut.device)
    cols = codes.to(torch.int64).T                                 # [S, C]
    for si in range(s):
        acc = acc + lut[:, si, :][:, cols[si]]
    return acc


def adc_topk(
    queries: torch.Tensor,    # [B, D] f32
    codebooks: torch.Tensor,  # [S, K, dsub] f32
    codes: torch.Tensor,      # [N, S] uint8
    norms: torch.Tensor,      # [N] f32 (true norms for the cosine normalization)
    valid: torch.Tensor,      # [N] bool
    k: int,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate cosine top-k via ADC: dot(q, x) ~ sum_s LUT[s, code[x, s]]
    with LUT[s, j] = dot(q_s, codebook[s, j]), divided by |x| |q|. Returns
    (scores [B, k'], slots [B, k']) with k' = min(k, rows reachable)."""
    b, d = queries.shape
    s, _, dsub = codebooks.shape
    q = queries.to(torch.float32)
    lut = torch.einsum("bsd,skd->bsk", q.reshape(b, s, dsub), codebooks.to(torch.float32))
    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)

    def score(lo, hi):
        dots = adc_scores(lut, codes[lo:hi])
        scores = dots / torch.clamp(norms[None, lo:hi] * qn, min=1e-12)
        return torch.where(valid[None, lo:hi], scores, NEG_INF)

    return chunked_topk(score, codes.shape[0], chunk, k)

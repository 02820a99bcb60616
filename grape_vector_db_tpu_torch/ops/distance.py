"""Batched distance scoring + top-k over device-resident vector shards.

PyTorch counterpart of ``grape_vector_db_tpu/ops/distance.py``, with the same
contract: the corpus is a fixed-capacity ``[capacity, dim]`` tensor (bf16 by
default) plus f32 norms and a validity mask; a query batch ``[B, dim]`` is
scored in one f32-accumulated matmul and selected with an exact top-k.

Selection is ``torch.topk``, which is exact, so the TPU-only selection
engines of the reference (iterative max-and-mask, the verified approx engine,
``approx_max_k``) are not ported: ``mode="approx"`` returns exact results.
Large corpora route to the segment top-k kernels (``ops/segmax.py``) under
the reference's routing condition; every other shape the fast path cannot
hold runs the exact chunked scan.

Similarity conventions (higher = better), matching the reference:
- cosine:     q.v / (|q||v|), clamped to 1.0
- dot:        q.v
- euclidean:  -|q - v|^2      (negated squared L2; monotonic with L2)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["l2_normalize", "prepare_queries", "score_block", "scored_topk",
           "chunked_topk", "f32_dots"]

NEG_INF = float("-inf")

# Scores must be f32 products of the stored values. A float32 matmul on the
# card may otherwise run in TF32 (about three decimal digits), and a bf16
# matmul may reduce in bf16; both would break exact top-k. These are
# process-wide PyTorch settings, set once when the port's ops load.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

# [B, N] f32 score-matrix budget before falling back to the chunked scan
# (2**27 elements = 512 MB).
MAX_SCORE_ELEMS = 2**27

# Segment-kernel routing (reference ops/distance.py:283-314). The values were
# tuned on a TPU v5e and have not been re-measured on the GPU yet; they are
# module constants so tests can lower them.
SEGMAX_MIN_ROWS = 262_144      # above this many rows every batch takes it
SEGMAX_MID_ROWS = 131_072      # from this many rows ...
SEGMAX_MID_BATCH = 128         # ... batches larger than this take it
SEGMAX_MAX_BATCH = 256         # the kernels' batch cap
SEGMAX_MAX_K = 64


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    x = x.to(torch.float32)
    n = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=eps)


def prepare_queries(queries: torch.Tensor, metric: str) -> torch.Tensor:
    """Cosine queries get L2-normalized once so the per-chunk work is a plain
    matmul + corpus-norm division."""
    q = queries.to(torch.float32)
    if metric == "cosine":
        q = l2_normalize(q)
    return q


def f32_dots(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """[B, D] f32 queries x [C, D] stored rows -> [B, C] f32 dots.

    The queries are cast to the storage dtype first (the reference scores
    bf16(q) against bf16 rows with f32 accumulation). ``torch.mm`` of two
    bf16 tensors returns bf16, so the f32 result is asked for explicitly:
    on CUDA with ``out_dtype``; on the CPU, which has no kernel for that
    overload, by upcasting both operands (products of bf16 values are exact
    in f32)."""
    qc = q.to(vecs.dtype)
    if vecs.dtype == torch.float32:
        return qc @ vecs.T
    if vecs.is_cuda:
        return torch.mm(qc, vecs.T, out_dtype=torch.float32)
    return qc.to(torch.float32) @ vecs.to(torch.float32).T


def score_block(
    q: torch.Tensor,       # [B, D] f32 (already prepare_queries'd)
    vecs: torch.Tensor,    # [C, D] storage dtype
    norms: torch.Tensor,   # [C]    f32  (L2 norms of the stored rows)
    valid: torch.Tensor,   # [C]    bool
    metric: str,
) -> torch.Tensor:
    """Score one corpus block: returns [B, C] f32, -inf where invalid."""
    dots = f32_dots(q, vecs)
    if metric == "cosine":
        # clamp: bf16 rounding can push a self-match epsilon above 1.0
        scores = torch.clamp(dots / torch.clamp(norms, min=1e-12)[None, :], max=1.0)
    elif metric == "dot":
        scores = dots
    elif metric == "euclidean":
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)  # [B, 1]
        v_sq = (norms * norms)[None, :]  # [1, C]
        scores = -(q_sq - 2.0 * dots + v_sq)
    else:
        raise ValueError(f"unknown metric: {metric}")
    return torch.where(valid[None, :], scores, NEG_INF)


def _segmax_route(n: int, d: int, b: int, kk: int, metric: str, mode: str,
                  chunk: int) -> bool:
    """The reference's routing condition for the segment kernels."""
    from grape_vector_db_tpu_torch.ops.segmax import CB, SEG

    big_n = n > SEGMAX_MIN_ROWS
    return (
        mode == "exact"
        and kk <= SEGMAX_MAX_K
        and (big_n or (n >= SEGMAX_MID_ROWS and b > SEGMAX_MID_BATCH))
        and n % SEG == 0
        and (n <= chunk or n % chunk == 0)
        and metric in ("cosine", "dot")
        and n % CB == 0
        and d % 128 == 0
        and b <= SEGMAX_MAX_BATCH
    )


def scored_topk(
    queries: torch.Tensor,   # [B, D] raw f32 queries
    vectors: torch.Tensor,   # [N, D] storage dtype, N % chunk == 0 (capacity-padded)
    norms: torch.Tensor,     # [N] f32
    valid: torch.Tensor,     # [N] bool
    k: int,
    metric: str = "cosine",
    chunk: int = 65536,
    mode: str = "exact",
    recall_target: float = 0.99,
    mask: Optional[torch.Tensor] = None,  # [N] bool filter mask (True = allowed)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k scan over the whole shard.

    Returns (scores [B, k] f32, slot indices [B, k] int64). Invalid / padding
    rows can only appear in the tail of results when fewer than k valid rows
    exist; their score is -inf and their index 0.

    ``mask`` is fused into the same validity predicate the scan already
    applies, so a selective filter still returns the exact top-k over the
    allowed rows. Every ``mode`` is exact; only ``"exact"`` takes the
    segment kernels, as in the reference's routing. ``recall_target`` is
    the reference's knob for its approximate selection and is ignored.
    """
    n, d = vectors.shape
    b = queries.shape[0]
    if mask is not None:
        valid = torch.logical_and(valid, mask)
    kk = min(k, n)

    if _segmax_route(n, d, b, kk, metric, mode, chunk):
        # Segment top-k kernels: the corpus streams once and only the top few
        # values of each 32-row segment leave the kernel; a small phase 2
        # rescores a handful of segments exactly. k >= 4 takes the top-4
        # kernel, smaller k the top-2 kernel (reference :328-332).
        from grape_vector_db_tpu_torch.ops.segmax import (segmax2_topk,
                                                          segmax4_topk)

        eng = segmax4_topk if kk >= 4 else segmax2_topk
        vals, idxs = eng(queries, vectors, norms, valid, k=kk, metric=metric)
        return _pad_k(vals, idxs, k)

    q = prepare_queries(queries, metric)
    if b * n <= MAX_SCORE_ELEMS:
        # Fast path: one matmul, full [B, N] scores, exact top-k.
        scores = score_block(q, vectors, norms, valid, metric)
        vals, idxs = torch.topk(scores, kk, dim=1)
        return _pad_k(vals, idxs, k)

    # Memory fallback: chunked scan, never materializing all scores.
    chunk = min(chunk, n)
    if n % chunk:
        raise ValueError(f"capacity {n} must be a multiple of chunk {chunk}")
    vals, idxs = chunked_topk(
        lambda lo, hi: score_block(q, vectors[lo:hi], norms[lo:hi], valid[lo:hi], metric),
        n, chunk, k)
    return _pad_k(vals, idxs, k)


def _largest(vals: torch.Tensor, slots: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    top, pos = torch.topk(vals, k, dim=1)
    return top, torch.gather(slots, 1, pos)


def chunked_topk(
    score_chunk: Callable[[int, int], torch.Tensor],
    n: int,
    chunk: int,
    k: int,
    select: Callable = _largest,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best k of n rows, scored ``chunk`` rows at a time, then one merge.

    ``score_chunk(lo, hi)`` returns the [B, hi - lo] scores of rows lo..hi-1
    with invalid rows already masked; ``select(vals, slots, k)`` keeps each
    row's best k (values, slots) in order (default: the k largest). Returns
    (values [B, k'], slots [B, k'] int64) with k' = min(k, n)."""
    part_v, part_s = [], []
    for lo in range(0, n, chunk):
        vals = score_chunk(lo, min(lo + chunk, n))
        slots = torch.arange(lo, lo + vals.shape[1], device=vals.device).expand_as(vals)
        v, s = select(vals, slots, min(k, vals.shape[1]))
        part_v.append(v)
        part_s.append(s)
    if len(part_v) == 1:
        return part_v[0], part_s[0]
    vals, slots = torch.cat(part_v, dim=1), torch.cat(part_s, dim=1)
    return select(vals, slots, min(k, vals.shape[1]))


def _pad_k(vals: torch.Tensor, idxs: torch.Tensor, k: int,
           fill=NEG_INF) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad result columns with (fill, 0) up to k when the corpus was < k rows."""
    got = vals.shape[1]
    if got >= k:
        return vals[:, :k], idxs[:, :k]
    pad = k - got
    vals = torch.nn.functional.pad(vals, (0, pad), value=fill)
    idxs = torch.nn.functional.pad(idxs, (0, pad), value=0)
    return vals, idxs

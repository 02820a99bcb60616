"""Per-row symmetric int8 quantization.

PyTorch counterpart of ``grape_vector_db_tpu/ops/int8.py``'s
``quantize_int8``: codes ``vi = round(v / s)`` clipped to [-127, 127] with
``s = max|v| / 127`` per row. The IVF int8 lists store these codes plus a
per-row ``factor`` that folds the scale and the cosine norm division
(``ops/ivf.py`` ``make_factor``). The flat int8 kind scans its codes with
``int8_topk``.

The int8 x int8 product of the scan runs as bf16 x bf16 with an f32 result
(``ops/distance.f32_dots``), on the card and on the CPU alike: codes and the
quantized query are exact in bf16, each product is exact, and an f32 sum of
D products of at most 127^2 is an exact integer while D * 127^2 < 2^24, that
is for D <= 1040 (``EXACT_LANES``; 768 by default). Wider rows are summed in
slices of at most 1040 lanes, each slice's exact sum cast to int32 and the
slices added in int32, so the scores equal the reference's int32 products at
any width. One code path serves both devices; ``torch._int_mm`` (int32
results on CUDA) is a private op whose shape rules (more than 16 rows, the
inner and outer sizes multiples of 8) the padded batch of 8 breaks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grape_vector_db_tpu_torch.ops.distance import _pad_k, chunked_topk, f32_dots

__all__ = ["quantize_int8", "int8_topk", "EXACT_LANES"]

NEG_INF = float("-inf")
#: Lanes an f32-accumulated product of int8 values sums exactly (1040 * 127^2 < 2^24).
EXACT_LANES = 1040


def quantize_int8(vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, D] -> (codes [M, D] int8, scale [M] f32 = max|v| / 127)."""
    vf = vecs.to(torch.float32)
    # times the f32 reciprocal, not divided: XLA rewrites the reference's
    # division by a constant so, and the scales then agree bit for bit
    s = torch.amax(torch.abs(vf), dim=1) * (1.0 / 127.0)
    vi = torch.clamp(torch.round(vf / torch.clamp(s, min=1e-12)[:, None]), -127, 127)
    return vi.to(torch.int8), s


def int8_topk(
    queries: torch.Tensor,  # [B, D] f32 raw
    codes: torch.Tensor,    # [N, D] int8 (capacity-padded)
    factor: torch.Tensor,   # [N] f32 = scale / |v| (cosine) or scale (dot)
    valid: torch.Tensor,    # [N] bool
    k: int,
    chunk: int = 131_072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k approximate cosine over the int8 corpus, a chunk at a time, then
    a merge. Returns (scores [B, k] f32, slots [B, k] int64): candidates for
    an exact rescore (``index/int8.py``); the scores are the quantized
    approximation ``(qi . vi) * q_scale * factor``."""
    qf = queries.to(torch.float32)
    qf = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=1, keepdim=True), min=1e-12)
    qs = torch.amax(torch.abs(qf), dim=1, keepdim=True) * (1.0 / 127.0)
    qi = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.bfloat16)

    def score(lo, hi):
        scores = _int8_dots(qi, codes[lo:hi]) * factor[None, lo:hi] * qs
        return torch.where(valid[None, lo:hi], scores, NEG_INF)

    v, s = chunked_topk(score, codes.shape[0], chunk, k)
    return _pad_k(v, s, k)


def _int8_dots(qi: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, D] bf16 int8-valued x [C, D] int8 -> [B, C] f32: the exact int32
    products, rounded to f32 once, as the reference's int32 -> f32 cast."""
    d = codes.shape[1]
    if d <= EXACT_LANES:
        return f32_dots(qi, codes.to(torch.bfloat16))
    acc = None
    for lo in range(0, d, EXACT_LANES):
        hi = lo + EXACT_LANES
        part = f32_dots(qi[:, lo:hi], codes[:, lo:hi].to(torch.bfloat16)).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc.to(torch.float32)

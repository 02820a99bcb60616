"""Per-row symmetric int8 quantization.

PyTorch counterpart of ``grape_vector_db_tpu/ops/int8.py``'s
``quantize_int8``: codes ``vi = round(v / s)`` clipped to [-127, 127] with
``s = max|v| / 127`` per row. The IVF int8 lists store these codes plus a
per-row ``factor`` that folds the scale and the cosine norm division
(``ops/ivf.py`` ``make_factor``). The flat int8 kind's scan (``int8_topk``)
belongs to a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_int8"]


def quantize_int8(vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, D] -> (codes [M, D] int8, scale [M] f32 = max|v| / 127)."""
    vf = vecs.to(torch.float32)
    # times the f32 reciprocal, not divided: XLA rewrites the reference's
    # division by a constant so, and the scales then agree bit for bit
    s = torch.amax(torch.abs(vf), dim=1) * (1.0 / 127.0)
    vi = torch.clamp(torch.round(vf / torch.clamp(s, min=1e-12)[:, None]), -127, 127)
    return vi.to(torch.int8), s

"""Per-row symmetric int4 quantization, packed split-plane.

PyTorch counterpart of ``grape_vector_db_tpu/ops/int4.py``. Codes are
offset-binary, ``u = clip(round(v / s), -8, 7) + 8`` in 0..15 with
``s = max|v| / 7`` per row, and byte ``j`` of a packed row holds dim ``j`` in
its low nibble and dim ``j + D/2`` in its high nibble (the reference's layout,
so codes compare bit for bit). The bytes are int8-typed: they carry the
unsigned packed value's bit pattern, and readers take the nibbles as
``byte & 0xF`` and ``(byte >> 4) & 0xF`` after sign extension.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_int4", "unpack_int4", "unpack_int4_split"]


def quantize_int4(vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, D] -> (packed [M, D/2] int8 split-plane, scale [M] f32). D even."""
    vf = vecs.to(torch.float32)
    d = vf.shape[1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")
    # times the f32 reciprocal, as in ops/int8.py (bit-equal scales)
    s = torch.amax(torch.abs(vf), dim=1) * (1.0 / 7.0)
    q = torch.clamp(torch.round(vf / torch.clamp(s, min=1e-12)[:, None]), -8, 7)
    u = (q + 8.0).to(torch.uint8)                           # [M, D] in 0..15
    packed = u[:, : d // 2] | (u[:, d // 2:] << 4)          # [M, D/2]
    return packed.view(torch.int8), s


def unpack_int4_split(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D/2] int8 -> (lo, hi) [..., D/2] f32 levels in -8..7: ``lo``
    holds dims [0, D/2), ``hi`` dims [D/2, D)."""
    p32 = packed.to(torch.int32)
    lo = (p32 & 0xF).to(torch.float32) - 8.0
    hi = ((p32 >> 4) & 0xF).to(torch.float32) - 8.0
    return lo, hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D/2] int8 -> [..., D] f32 dequantized levels (unscaled)."""
    lo, hi = unpack_int4_split(packed)
    return torch.cat([lo, hi], dim=-1)

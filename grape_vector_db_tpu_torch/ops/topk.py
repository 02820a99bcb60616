"""Top-k selection with ``lax.top_k``'s tie rule, and the top-k merge.

PyTorch counterpart of ``grape_vector_db_tpu/ops/topk.py``. ``lax.top_k``
puts the lower index first among equal values; ``torch.topk`` gives ties in
no defined order, on the CPU or the card. ``top_k`` therefore selects with a
stable descending sort and a slice, so equal values (``-inf`` runs among
them) come out lowest position first, as in the reference. Every selection
of the graph path goes through it.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["top_k", "merge_topk", "take_topk"]


def top_k(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values along the last axis, descending,
    and their positions (int64); equal values keep the lower position first."""
    top, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return top[..., :k], pos[..., :k]


def merge_topk(
    vals_a: torch.Tensor, idx_a: torch.Tensor,
    vals_b: torch.Tensor, idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-source top-k lists ([B, ka], [B, kb]) into one top-k."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idxs = torch.cat([idx_a, idx_b], dim=-1)
    return take_topk(vals, idxs, k)


def take_topk(vals: torch.Tensor, idxs: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (vals, idxs) along the last axis, keeping idxs aligned."""
    k = min(k, vals.shape[-1])
    tv, tp = top_k(vals, k)
    return tv, torch.gather(idxs, -1, tp)

"""Int8DeviceIndex — two-stage int8 prescan + exact bf16 rescore, flat.

PyTorch counterpart of ``grape_vector_db_tpu/index/int8.py``: per-row
symmetric int8 codes (``ops/int8.py``) beside the bf16 rows the parent class
keeps; the int8 scan picks the top ``rescore`` candidates and the exact
rescore of ``index/binary.py`` (``_rescore_topk``) ranks them. Memory is 1.5x
the bf16 index (bf16 rows + int8 codes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.index.binary import _rescore_topk
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex, grow_rows
from grape_vector_db_tpu_torch.ops.hamming import INVALID_DIST
from grape_vector_db_tpu_torch.ops.int8 import int8_topk, quantize_int8
from grape_vector_db_tpu_torch.utils.buckets import next_bucket

__all__ = ["Int8DeviceIndex"]


class Int8DeviceIndex(FlatDeviceIndex):
    """Drop-in VectorIndex: int8 scan + exact rescore."""

    kind = "int8"

    def __init__(self, *args, rescore: int = 64, **kwargs):
        self.rescore = int(rescore)
        super().__init__(*args, **kwargs)
        if self.metric == "euclidean":
            # the int8 stage-1 proxy is a dot product: it cannot rank by L2
            raise ValueError("int8 index supports cosine/dot metrics")

    # -- storage hooks ---------------------------------------------------------

    def _alloc_extra(self, capacity: int) -> None:
        self.codes = torch.zeros((capacity, self._dim), dtype=torch.int8, device=self.device)
        self.scales = torch.zeros((capacity,), dtype=torch.float32, device=self.device)

    def _grow_extra(self, new_cap: int) -> None:
        self.codes = grow_rows(self.codes, new_cap)
        self.scales = grow_rows(self.scales, new_cap)

    def _write(self, slots, vecs, norms) -> None:
        super()._write(slots, vecs, norms)
        codes, scales = quantize_int8(vecs)
        self.codes.index_copy_(0, slots, codes)
        self.scales.index_copy_(0, slots, scales)

    def _load_extra(self, capacity: int, *, codes, scales) -> None:
        codes, scales = np.array(codes, dtype=np.int8), np.array(scales, dtype=np.float32)
        if codes.shape != (capacity, self._dim) or scales.shape != (capacity,):
            raise ValueError(f"codes must be [{capacity}, {self._dim}], scales [{capacity}]")
        self.codes = torch.from_numpy(codes).to(self.device)
        self.scales = torch.from_numpy(scales).to(self.device)

    # -- search ------------------------------------------------------------------

    def _rescore_count(self, k: int) -> int:
        return next_bucket(min(max(self.rescore, k), max(self.capacity, 1)), base=64)

    def _int8_topk(self, q: torch.Tensor, mask: Optional[torch.Tensor],
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        r = self._rescore_count(k)
        # factor folds the dequant scale and, for cosine, the norm
        # division; dot keeps row magnitudes (dividing would make the
        # stage-1 selection cosine and starve the exact-dot rescore of
        # high-norm candidates)
        if self.metric == "cosine":
            factor = self.scales / torch.clamp(self.norms, min=1e-12)
        else:
            factor = self.scales
        valid = self.valid if mask is None else self.valid & mask
        cvals, cand = int8_topk(q, self.codes, factor, valid, k=r,
                                chunk=min(131_072, self.capacity))
        dist_proxy = torch.where(torch.isfinite(cvals), 0, INVALID_DIST)
        return _rescore_topk(q, self.vectors, self.norms, cand, dist_proxy, k=k,
                             metric=self.metric)

    def raw_topk(self, queries: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        return self._device_call(lambda q, m: self._int8_topk(q, m, k), queries, mask)

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        stats.extra["int8_mb"] = self.capacity * (self._dim + 4) / 1e6
        stats.extra["rescore_k"] = float(self._rescore_count(10))
        return stats

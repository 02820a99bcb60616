"""Int8IvfDeviceIndex — IVF partitioning over int8-resident lists.

PyTorch counterpart of ``grape_vector_db_tpu/index/ivf_int8.py``. Lists hold
per-row symmetric int8 codes (``ops/int8.py``) and a ``[L, C]`` factor plane
that folds the dequant scale and the cosine norm division (0 = invalid); the
probe (``ops/ivf.py`` ``ivf_topk_int8``) reads half the bytes of a bf16 list.

Two configurations (``config.index.ivf_int8_keep_bf16``):

- **bandwidth** (``keep_bf16=True``, default): codes plus the bf16 shadow
  lists; the top ``rescore`` int8 candidates are rescored exactly against
  the bf16 rows.
- **capacity** (``keep_bf16=False``): codes only; scores are bf16-query x
  dequantized-code dots, and get_vector / get_all / optimize() dequantize.
"""

from __future__ import annotations

import numpy as np
import torch

from grape_vector_db_tpu_torch.index.ivf import IvfDeviceIndex, _from_numpy
from grape_vector_db_tpu_torch.ops.int8 import quantize_int8
from grape_vector_db_tpu_torch.ops.ivf import ivf_topk_int8, make_factor
from grape_vector_db_tpu_torch.utils.buckets import next_bucket

__all__ = ["Int8IvfDeviceIndex"]


class Int8IvfDeviceIndex(IvfDeviceIndex):
    kind = "ivf_int8"

    def __init__(self, *args, rescore: int = 64, keep_bf16: bool = True, **kwargs):
        if kwargs.get("metric", "cosine") == "euclidean":
            raise ValueError(f"{self.kind} supports cosine/dot metrics")
        self.rescore = int(rescore)
        self.keep_bf16 = bool(keep_bf16)
        super().__init__(*args, **kwargs)

    # -- storage seams --------------------------------------------------------

    def _alloc(self, cap: int) -> None:
        l = self.nlist
        if self.keep_bf16:
            super()._alloc(cap)
        else:
            self.vecs = None
            self.norms = self._zeros((l, cap), torch.float32)
            self.valid = self._zeros((l, cap), torch.bool)
            self.recip = None
        self._alloc_codes(cap)
        self.scales = self._zeros((l, cap), torch.float32)
        self.factor = self._zeros((l, cap), torch.float32)

    def _alloc_codes(self, cap: int) -> None:
        self.codes = self._zeros((self.nlist, cap, self._dim), torch.int8)

    _quantize = staticmethod(quantize_int8)

    def _scatter_rows(self, lists, pos, vecs, norms) -> None:
        if self.keep_bf16:
            super()._scatter_rows(lists, pos, vecs, norms)
        else:
            self.norms[lists, pos] = norms
            self.valid[lists, pos] = True
        # quantized from the storage-dtype rows the bf16 plane would hold
        codes, s = self._quantize(vecs)
        self.codes[lists, pos] = codes
        self.scales[lists, pos] = s
        self.factor[lists, pos] = (s / torch.clamp(norms, min=1e-12)
                                   if self.metric == "cosine" else s)

    def _invalidate_cells(self, lists, pos) -> None:
        super()._invalidate_cells(lists, pos)
        self.factor[lists, pos] = 0.0

    def _dequant_rows(self, codes: torch.Tensor) -> torch.Tensor:
        return codes.to(torch.float32)

    def _rows_at(self, lists, pos) -> torch.Tensor:
        if self.keep_bf16:
            return super()._rows_at(lists, pos)
        return self._dequant_rows(self.codes[lists, pos]) * self.scales[lists, pos][:, None]

    def load_state(self, *, codes, scales, factor, **state) -> None:
        """``IvfDeviceIndex.load_state`` plus the code planes: ``codes``,
        ``scales`` and ``factor`` (``[L, C]`` or the reference's ``[L, 8, C]``;
        None, as the reference keeps none where its kernel is off: made
        from the scales, norms and validity)."""
        super().load_state(**state)
        with self._lock:
            self.codes = _from_numpy(codes, torch.int8, self.device)
            self.scales = _from_numpy(scales, torch.float32, self.device)
            if factor is None:
                self.factor = make_factor(self.scales, self.norms, self.valid, self.metric)
                return
            factor = np.asarray(factor)
            factor = factor[:, 0, :] if factor.ndim == 3 else factor
            self.factor = _from_numpy(factor, torch.float32, self.device)

    # -- search ----------------------------------------------------------------

    def _rescore_count(self, k: int) -> int:
        if not self.keep_bf16:
            return 0
        return next_bucket(max(self.rescore, k), base=64)

    def _scan_planes(self):
        return self.codes, self.factor, "int8"

    _topk = staticmethod(ivf_topk_int8)

    def _main_topk(self, qp: torch.Tensor, k: int, mask, nprobe=None):
        nprobe = min(nprobe or self.nprobe, self.nlist)
        r = self._rescore_count(k)
        return self._topk(
            qp, self.centroids, self.codes, self.factor, k=k, nprobe=nprobe,
            metric=self.metric, rescore=r, vecs=self.vecs if r else None,
            recip=self.recip if r else None, cell_mask=self._mask_tensor(mask),
            nblocks=self._nblocks())

    # -- introspection -----------------------------------------------------------

    def _code_bytes_per_row(self) -> int:
        return self._dim

    def get_stats(self):
        stats = super().get_stats()
        per_row = self._code_bytes_per_row() + 4 * 2 + 8 * 4  # codes + scale/norm + factor
        if self.keep_bf16:
            per_row += self.storage_dtype.itemsize * self._dim
        stats.memory_usage_mb = self.nlist * self.list_cap * per_row / 1e6
        stats.extra["keep_bf16"] = float(self.keep_bf16)
        stats.extra["rescore_k"] = float(self._rescore_count(10))
        return stats

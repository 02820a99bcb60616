"""Int4IvfDeviceIndex — IVF partitioning over packed-int4-resident lists.

PyTorch counterpart of ``grape_vector_db_tpu/index/ivf_int4.py``: packed
nibbles store half a byte a dim (a quarter of bf16), split-plane (byte ``j``
holds dim ``j`` low and dim ``j + D/2`` high; ``ops/int4.py``), so the probe
(``ops/ivf.py`` ``ivf_topk_int4``) reads half the bytes of an int8 list. The
two configurations are those of ``Int8IvfDeviceIndex``: ``keep_bf16=True``
rescores the top candidates against bf16 shadow lists, ``keep_bf16=False``
keeps codes only. The dim must be even; the CUDA probe also needs it to be a
multiple of 32 (16-byte loads of packed rows).
"""

from __future__ import annotations

import torch

from grape_vector_db_tpu_torch.index.ivf_int8 import Int8IvfDeviceIndex
from grape_vector_db_tpu_torch.ops.int4 import quantize_int4, unpack_int4
from grape_vector_db_tpu_torch.ops.ivf import ivf_topk_int4

__all__ = ["Int4IvfDeviceIndex"]


class Int4IvfDeviceIndex(Int8IvfDeviceIndex):
    kind = "ivf_int4"

    def _alloc_codes(self, cap: int) -> None:
        if self._dim % 2:
            raise ValueError(f"ivf_int4 needs an even dim, got {self._dim}")
        # int8-typed bytes holding the unsigned packed nibbles
        self.codes = self._zeros((self.nlist, cap, self._dim // 2), torch.int8)

    _quantize = staticmethod(quantize_int4)
    _topk = staticmethod(ivf_topk_int4)

    def _dequant_rows(self, codes: torch.Tensor) -> torch.Tensor:
        return unpack_int4(codes)

    def _scan_planes(self):
        return self.codes, self.factor, "int4"

    def _code_bytes_per_row(self) -> int:
        return self._dim // 2

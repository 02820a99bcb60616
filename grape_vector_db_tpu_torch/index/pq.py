"""PqDeviceIndex — product-quantized ADC prescan + exact rescore.

PyTorch counterpart of ``grape_vector_db_tpu/index/pq.py``. Full-precision
rows stay on the device for the exact rescore (``index/binary.py``
``_rescore_topk``); the prescan runs ADC over uint8 PQ codes (``ops/pq.py``).
Codebooks train on the first batch that brings the index to
``train_threshold`` rows (or on ``train()``); codes of rows inserted before
training are filled in then. Until trained, search is the parent's exact
scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.index.binary import _rescore_topk
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex, grow_rows
from grape_vector_db_tpu_torch.ops.hamming import INVALID_DIST
from grape_vector_db_tpu_torch.ops.pq import adc_topk, encode_pq, train_pq
from grape_vector_db_tpu_torch.utils.buckets import next_bucket

__all__ = ["PqDeviceIndex"]


class PqDeviceIndex(FlatDeviceIndex):
    kind = "pq"

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        n_sub: Optional[int] = None,
        nbits: int = 8,
        rescore_ratio: float = 0.05,
        max_rescore: int = 4096,
        train_threshold: int = 1024,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        device: str | torch.device = "cuda",
    ):
        if n_sub is None:
            n_sub = max(1, dimension // 8)  # 8 dims per subspace by default
        if dimension % n_sub:
            raise ValueError(f"dimension {dimension} not divisible by n_sub {n_sub}")
        self.n_sub = n_sub
        self.nbits = nbits
        self.rescore_ratio = rescore_ratio
        self.max_rescore = max_rescore
        self.train_threshold = max(train_threshold, 2 ** nbits)
        self.codebooks: Optional[torch.Tensor] = None   # [S, 2^nbits, dsub] f32
        super().__init__(dimension, metric=metric, storage_dtype=storage_dtype,
                         initial_capacity=initial_capacity, growth_factor=growth_factor,
                         search_mode=search_mode, recall_target=recall_target, device=device)

    @property
    def is_trained(self) -> bool:
        return self.codebooks is not None

    # -- storage hooks -----------------------------------------------------------

    def _alloc_extra(self, capacity: int) -> None:
        self.codes = torch.zeros((capacity, self.n_sub), dtype=torch.uint8, device=self.device)

    def _grow_extra(self, new_cap: int) -> None:
        self.codes = grow_rows(self.codes, new_cap)

    def _write(self, slots, vecs, norms) -> None:
        super()._write(slots, vecs, norms)
        if self.codebooks is not None:
            self.codes.index_copy_(0, slots, encode_pq(vecs, self.codebooks))
        elif len(self) >= self.train_threshold:
            self.train()

    def _load_extra(self, capacity: int, *, codes, codebooks=None) -> None:
        """``codes`` [capacity, S] uint8 and the trained ``codebooks``
        [S, 2^nbits, dsub] (None: untrained)."""
        codes = np.array(codes, dtype=np.uint8)
        if codes.shape != (capacity, self.n_sub):
            raise ValueError(f"codes must be [{capacity}, {self.n_sub}]")
        self.codes = torch.from_numpy(codes).to(self.device)
        self.codebooks = None if codebooks is None else torch.from_numpy(
            np.array(codebooks, dtype=np.float32)).to(self.device)

    # -- training ------------------------------------------------------------------

    def train(self, sample: Optional[np.ndarray] = None, seed: int = 0) -> None:
        if sample is None:
            _, sample = self.get_all()
        sample = np.asarray(sample, dtype=np.float32)
        if sample.shape[0] < 2 ** self.nbits:
            raise ValueError("not enough vectors to train PQ codebooks")
        if sample.shape[0] > 65536:
            sel = np.random.default_rng(seed).choice(sample.shape[0], 65536, replace=False)
            sample = sample[sel]
        self.codebooks = train_pq(torch.from_numpy(sample).to(self.device), n_sub=self.n_sub,
                                  nbits=self.nbits, seed=seed)
        # fill in the codes of everything already resident
        ids, vecs = self.get_all()
        if ids:
            slots = torch.as_tensor([self._id_to_slot[i] for i in ids], dtype=torch.int64)
            self.codes.index_copy_(0, slots.to(self.device),
                                   encode_pq(torch.from_numpy(vecs).to(self.device),
                                             self.codebooks))

    def optimize(self) -> None:
        """Retrain the codebooks on the current corpus."""
        if len(self) >= 2 ** self.nbits:
            self.train()

    # -- search ----------------------------------------------------------------------

    def _rescore_count(self, k: int) -> int:
        want = max(k, int(self.rescore_ratio * len(self)))
        want = min(want, self.max_rescore, max(self.capacity, 1))
        return next_bucket(max(want, k), base=64)

    def _pq_topk(self, q: torch.Tensor, mask: Optional[torch.Tensor],
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        r = self._rescore_count(k)
        # the filter mask folds into the ADC prescan's validity
        valid = self.valid if mask is None else self.valid & mask
        vals, cand = adc_topk(q, self.codebooks, self.codes, self.norms, valid, k=r,
                              chunk=min(65536, self.capacity))
        dist_proxy = torch.where(torch.isfinite(vals), 0, INVALID_DIST)
        return _rescore_topk(q, self.vectors, self.norms, cand, dist_proxy, k=k,
                             metric=self.metric)

    def raw_topk(self, queries: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        if self.codebooks is None:
            return super().raw_topk(queries, k, mask=mask)  # exact until trained
        return self._device_call(lambda q, m: self._pq_topk(q, m, k), queries, mask)

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        stats.is_built = self.is_trained
        stats.extra["n_sub"] = float(self.n_sub)
        stats.extra["code_bytes_per_vec"] = float(self.n_sub)
        stats.extra["rescore_k"] = float(self._rescore_count(10))
        return stats

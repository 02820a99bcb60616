"""BinaryDeviceIndex — two-stage search: packed-bit prescan + exact rescore.

PyTorch counterpart of ``grape_vector_db_tpu/index/binary.py``. Vectors are
threshold-binarized into packed 32-bit words (``ops/hamming.py``; int32
tensors holding the reference's uint32 bits) stored beside the
full-precision rows. A query first runs a prescan over the packed planes,
takes the best ``rescore_k`` candidates, then rescores them exactly with a
gather and returns the true top-k over them.

- ``prescan="asym"`` (default): rank candidates by
  ``dot(bf16(q_unit), sign(x))``, one f32-accumulated product.
- ``prescan="hamming"``: the reference's symmetric XOR/popcount ranking,
  through ``hamming_impl``: ``"mxu"`` (default; the +-1 decode product),
  ``"popcount"`` or ``"xla"`` (both the hand-written CUDA kernel on a CUDA
  tensor, the plain version on a CPU tensor; ``ops/hamming.py``).
- ``keep_vectors=False`` is the capacity configuration: only the codes stay
  on the device, the prescan ranking is the result, and ``get_vector`` /
  ``get_all`` reconstruct unit-norm sign vectors.

Selections are exact (the reference's TPU path selects with
``approx_max_k``); Hamming ties go to the lower slot, as there.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex, grow_rows
from grape_vector_db_tpu_torch.ops.distance import MAX_SCORE_ELEMS, prepare_queries
from grape_vector_db_tpu_torch.ops.hamming import (INVALID_DIST, asym_topk, hamming_topk,
                                                   pack_bits, words_per_vector)
from grape_vector_db_tpu_torch.utils.buckets import next_bucket, pad_rows

__all__ = ["BinaryDeviceIndex"]

_HAMMING_IMPLS = ("mxu", "popcount", "xla")


def _rescore_topk(queries: torch.Tensor, vectors: torch.Tensor, norms: torch.Tensor,
                 cand_idx: torch.Tensor, cand_dist: torch.Tensor, k: int,
                 metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather candidates and rescore exactly (the reference's
    ``_rescore_topk``, which the int8 and PQ indexes share).

    queries [B, D] f32, cand_idx [B, R] slots, cand_dist [B, R] int
    (``INVALID_DIST`` marks padding). Returns (scores [B, min(k, R)] f32,
    slots [B, min(k, R)] int64). Scores are f32 products of the stored
    values: the few gathered rows are upcast (bf16 products are exact)."""
    q = prepare_queries(queries, metric)
    idx = cand_idx.to(torch.int64)
    cvecs = vectors[idx].to(torch.float32)                       # [B, R, D]
    cnorms = norms[idx]                                          # [B, R]
    qc = q.to(vectors.dtype).to(torch.float32)
    dots = torch.bmm(cvecs, qc[:, :, None])[:, :, 0]
    if metric == "cosine":
        scores = torch.clamp(dots / torch.clamp(cnorms, min=1e-12), max=1.0)
    elif metric == "dot":
        scores = dots
    else:  # euclidean
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        scores = -(q_sq - 2.0 * dots + cnorms * cnorms)
    scores = torch.where(cand_dist < INVALID_DIST, scores, float("-inf"))
    vals, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return vals, torch.gather(idx, 1, pos)


class BinaryDeviceIndex(FlatDeviceIndex):
    """Two-stage binary-quantized index (drop-in VectorIndex)."""

    kind = "binary"

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        threshold: float = 0.0,
        rescore_ratio: float = 0.1,
        max_rescore: int = 4096,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        use_pallas: bool = True,
        keep_vectors: bool = True,
        hamming_impl: str = "mxu",
        prescan: str = "asym",
        device: str | torch.device = "cuda",
    ):
        self.keep_vectors = bool(keep_vectors)
        self.threshold = float(threshold)
        self.rescore_ratio = float(rescore_ratio)
        self.max_rescore = int(max_rescore)
        if hamming_impl not in _HAMMING_IMPLS:
            raise ValueError(f"hamming_impl must be one of {_HAMMING_IMPLS}, got {hamming_impl!r}")
        self.hamming_impl = hamming_impl
        if prescan not in ("asym", "hamming"):
            raise ValueError(f"prescan must be 'asym' or 'hamming', got {prescan!r}")
        self.prescan = prescan
        self._words = words_per_vector(dimension)
        super().__init__(dimension, metric=metric, storage_dtype=storage_dtype,
                         initial_capacity=initial_capacity, growth_factor=growth_factor,
                         search_mode=search_mode, recall_target=recall_target, device=device)

    # -- storage hooks ---------------------------------------------------------

    def _alloc(self, capacity: int) -> None:
        if self.keep_vectors:
            super()._alloc(capacity)
            return
        self.vectors = None
        self.norms = None
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.capacity = capacity
        self._alloc_extra(capacity)

    def _ensure_capacity(self, needed: int) -> None:
        if self.keep_vectors:
            super()._ensure_capacity(needed)
            return
        if needed <= self.capacity:
            return
        new_cap = next_bucket(needed, base=self._initial_capacity, factor=self._growth_factor)
        self.valid = grow_rows(self.valid, new_cap)
        self._grow_extra(new_cap)
        self._slot_to_id.extend([None] * (new_cap - self.capacity))
        self.capacity = new_cap

    def _alloc_extra(self, capacity: int) -> None:
        self.codes = torch.zeros((capacity, self._words), dtype=torch.int32, device=self.device)

    def _grow_extra(self, new_cap: int) -> None:
        self.codes = grow_rows(self.codes, new_cap)

    def _write(self, slots, vecs, norms) -> None:
        if self.keep_vectors:
            super()._write(slots, vecs, norms)
        else:
            self.valid.index_fill_(0, slots, True)
        self.codes.index_copy_(0, slots, pack_bits(vecs, self.threshold))

    def _load_extra(self, capacity: int, *, codes) -> None:
        """``codes``: [capacity, W] words, uint32 (the reference's) or int32."""
        codes = np.array(codes)
        if codes.shape != (capacity, self._words) or codes.dtype.itemsize != 4:
            raise ValueError(f"codes must be [{capacity}, {self._words}] 32-bit words")
        self.codes = torch.from_numpy(codes.view(np.int32)).to(self.device)

    # -- search ------------------------------------------------------------------

    def _scan_chunk(self) -> int:
        """Rows one prescan step scores: the whole capacity up to 262,144,
        which bounds the +-1 decode's transient (the reference's rule)."""
        return min(self.capacity, 262_144)

    def _asym_chunk(self, b: int) -> int:
        """Rows one asym prescan step scores for b queries. The card's kernel
        decodes in registers, so one launch takes as many rows as its [b, rows]
        f32 scores may hold (the whole 1M capacity at b = 8: one selection
        beats four and a merge, PERF.md); the plain version keeps the
        decode's bound."""
        if self.codes.is_cuda:
            return max(self._scan_chunk(), MAX_SCORE_ELEMS // b)
        return self._scan_chunk()

    def _rescore_count(self, k: int) -> int:
        n = len(self)
        want = max(k, int(self.rescore_ratio * n))
        want = min(want, self.max_rescore, max(self.capacity, 1))
        return next_bucket(max(want, k), base=64)

    def _binary_topk(self, q: torch.Tensor, mask: Optional[torch.Tensor],
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        chunk = self._scan_chunk()
        # the filter mask folds into the prescan's validity, so both
        # stages only ever consider allowed rows
        valid = self.valid if mask is None else self.valid & mask
        if not self.keep_vectors:
            # capacity config: the prescan ranking is the result
            if self.prescan == "asym":
                vals, idxs = asym_topk(q, self.codes, valid, k=k,
                                       chunk=self._asym_chunk(q.shape[0]))
                # similarity = cosine against the decoded sign vector
                return vals / float(np.sqrt(self._dim)), idxs
            return hamming_topk(pack_bits(q, self.threshold), self.codes, valid, k=k,
                                chunk=chunk, impl=self.hamming_impl)
        r = self._rescore_count(k)
        if self.prescan == "asym":
            pv, cand = asym_topk(q, self.codes, valid, k=r, chunk=self._asym_chunk(q.shape[0]))
            # the rescore's validity channel is the Hamming plane;
            # synthesize it from the -inf padding sentinel
            dists = torch.where(torch.isfinite(pv), 0, INVALID_DIST)
        else:
            dists, cand = hamming_topk(pack_bits(q, self.threshold), self.codes, valid, k=r,
                                       chunk=chunk, impl=self.hamming_impl)
        return _rescore_topk(q, self.vectors, self.norms, cand, dists, k=k, metric=self.metric)

    def raw_topk(self, queries: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        vals, idxs = self._device_call(lambda q, m: self._binary_topk(q, m, k), queries, mask)
        if self.keep_vectors:
            return vals, idxs
        if self.prescan == "asym":
            return np.where(np.isfinite(vals), vals, -np.inf), idxs
        d_np = vals.astype(np.float32)
        sims = 1.0 - d_np / np.float32(self._dim)
        return np.where(d_np >= INVALID_DIST, -np.inf, sims), idxs

    # -- maintenance ------------------------------------------------------------

    def tune_rescore(self, queries: Optional[np.ndarray] = None, k: int = 10,
                     target_recall: float = 0.95, max_budget: int = 8192) -> int:
        """Pick (and set) the smallest rescore budget whose recall@k on a
        validation query set meets ``target_recall``, against this index's
        own exact full-precision scan as the oracle. ``queries`` defaults to
        a sample of the indexed vectors (the self-recall protocol);
        candidate budgets double. Only the two-stage config has a rescore
        stage."""
        if not self.keep_vectors:
            raise ValueError("tune_rescore needs the two-stage config "
                             "(keep_vectors=True); the codes-only capacity "
                             "config has no rescore stage")
        with self._lock:
            if not self._id_to_slot:
                return self.max_rescore
            if queries is None:
                slots = torch.as_tensor(list(self._id_to_slot.values())[:256], dtype=torch.int64)
                queries = self.vectors[slots.to(self.device)].to(torch.float32).cpu().numpy()
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        qp = pad_rows(queries, next_bucket(b, base=8))
        # oracle: the exact full-precision scan over all rows
        o_vals, o_slots = FlatDeviceIndex.raw_topk(self, qp, k)
        oracle = [frozenset(int(s) for v, s in zip(vr, sr) if np.isfinite(v))
                  for vr, sr in zip(o_vals[:b], o_slots[:b])]
        denom = sum(len(w) for w in oracle) or 1
        limit = min(int(max_budget), self.capacity)
        saved = (self.rescore_ratio, self.max_rescore)
        chosen: Optional[int] = None
        try:
            cand = next_bucket(max(64, k), base=64)
            while True:
                self.rescore_ratio = 1.0
                self.max_rescore = cand
                vals, slots = self.raw_topk(qp, k)
                hits = sum(
                    len({int(s) for v, s in zip(vr, sr) if np.isfinite(v)} & want)
                    for vr, sr, want in zip(vals[:b], slots[:b], oracle))
                if hits / denom >= target_recall or cand >= limit:
                    chosen = cand
                    return cand
                cand = min(cand * 2, limit)
        finally:
            if chosen is None:
                self.rescore_ratio, self.max_rescore = saved
            else:
                n = len(self._id_to_slot) or 1
                self.rescore_ratio = min(1.0, chosen / n)
                self.max_rescore = chosen

    def hamming_only_topk(self, queries: np.ndarray, k: int) -> List[List[SearchHit]]:
        """Stage-1-only search (similarity = 1 - d/dim), the reference's
        pure-Hamming mode."""
        qp, b = self._padded_queries(queries)
        if qp is None:
            return [[] for _ in range(b)]
        dists, idxs = self._device_call(
            lambda q, _: hamming_topk(pack_bits(q, self.threshold), self.codes, self.valid, k=k,
                                      chunk=self._scan_chunk(), impl=self.hamming_impl),
            qp, rows=b)
        sims = 1.0 - dists.astype(np.float64) / float(self._dim)
        sims = np.where(dists >= INVALID_DIST, -np.inf, sims)
        return self.hits_from_slots(sims, idxs)

    # -- introspection (capacity config reconstructs sign vectors) -------------

    def _decode_signs(self, slots: np.ndarray) -> np.ndarray:
        codes = self.codes[torch.from_numpy(slots).to(self.device)].cpu().numpy()
        codes = codes.view(np.uint32)                                # [M, W]
        bits = (codes[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        signs = (2.0 * bits.astype(np.float32) - 1.0).reshape(len(slots), -1)
        return signs[:, :self._dim] / np.sqrt(self._dim)

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        if self.keep_vectors:
            return super().get_vector(id_)
        slot = self._id_to_slot.get(id_)
        if slot is None:
            return None
        return self._decode_signs(np.asarray([slot], dtype=np.int64))[0]

    def get_all(self):
        if self.keep_vectors:
            return super().get_all()
        with self._lock:
            items = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if not items:
                return [], np.zeros((0, self._dim), dtype=np.float32)
            ids = [i for i, _ in items]
            slots = np.asarray([s for _, s in items], dtype=np.int64)
            return ids, self._decode_signs(slots)

    def get_stats(self) -> IndexStats:
        if self.keep_vectors:
            stats = super().get_stats()
        else:
            stats = IndexStats(point_count=len(self._id_to_slot), dimension=self._dim,
                               capacity=self.capacity,
                               memory_usage_mb=self.capacity * (self._words * 4 + 1) / 1e6)
        stats.kind = self.kind
        stats.extra["packed_mb"] = self.capacity * self._words * 4 / 1e6
        stats.extra["keep_vectors"] = float(self.keep_vectors)
        stats.extra["rescore_k"] = float(self._rescore_count(10))
        stats.extra["prescan_asym"] = float(self.prescan == "asym")
        return stats

"""FlatDeviceIndex — exact search over fixed-capacity device-resident tensors.

PyTorch counterpart of ``grape_vector_db_tpu/index/flat.py``: the corpus is a
``[capacity, dim]`` tensor (bf16 by default) + f32 norms + a validity mask on
an explicit ``device``. Upserts and deletes write in place into those tensors
(no rebuild); search is the scan + top-k in ops/distance.py.

Capacity grows by bucket doubling. Deletes tombstone slots via the validity
mask and recycle them on later inserts.

Unlike the JAX index, a write batch is not padded to a bucket: PyTorch has no
"drop" scatter mode for out-of-range pad slots, and eager execution needs no
static shapes, so ``index_copy_`` writes only the real rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.device_call import DeviceCalls
from grape_vector_db_tpu_torch.index.hits import hits_from_arrays
from grape_vector_db_tpu_torch.ops.distance import scored_topk
from grape_vector_db_tpu_torch.utils.buckets import next_bucket
from grape_vector_db_tpu_torch.utils.tracing import trace_span

__all__ = ["FlatDeviceIndex", "FlatIndex", "grow_rows", "ship_batch"]

_SEARCH_CHUNK = 65536

_STORAGE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def grow_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows`` (a new tensor)."""
    out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[:t.shape[0]].copy_(t)
    return out


def ship_batch(arr: np.ndarray, storage_dtype) -> torch.Tensor:
    """A host batch as a CPU tensor in the storage dtype (a name such as
    ``"bfloat16"``, or a torch dtype), cast on the host before the upload
    when the dtype is narrower than f32: half the bytes cross to the device
    in bf16. The cast rounds to nearest even, as the device's does, so the
    stored values are the same either way."""
    dt = _STORAGE_DTYPES.get(storage_dtype, storage_dtype)
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return t.to(dt) if dt.itemsize < 4 else t


def _row_norms(vecs: torch.Tensor) -> torch.Tensor:
    """f32 L2 norms of rows as stored (computed from the storage-dtype rows)."""
    v = vecs.to(torch.float32)
    return torch.sqrt(torch.sum(v * v, dim=1))


class FlatDeviceIndex(DeviceCalls, VectorIndex):
    """Exact device-scan index (recall = 1.0 by construction)."""

    kind = "flat"
    supports_mask = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cosine", "dot", "euclidean"):
            raise ValueError(f"unknown metric {metric}")
        if search_mode not in ("exact", "approx"):
            raise ValueError(f"unknown search_mode {search_mode}")
        if storage_dtype not in _STORAGE_DTYPES:
            raise ValueError(f"storage_dtype {storage_dtype!r} is not ported; "
                             f"use one of {sorted(_STORAGE_DTYPES)}")
        self._dim = dimension
        self.metric = metric
        self.search_mode = search_mode
        self.recall_target = recall_target   # accepted, unused: every selection is exact
        self.storage_dtype = _STORAGE_DTYPES[storage_dtype]
        self._initial_capacity = initial_capacity
        self._growth_factor = growth_factor
        self.device = torch.device(device)
        self._init_device_calls()
        self._alloc(initial_capacity)
        # Host id <-> slot bookkeeping.
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: List[Optional[str]] = [None] * initial_capacity
        self._free: List[int] = []
        self._high_water = 0  # slots ever handed out

    # -- allocation ---------------------------------------------------------

    def _alloc(self, capacity: int) -> None:
        self.vectors = torch.zeros((capacity, self._dim), dtype=self.storage_dtype,
                                   device=self.device)
        self.norms = torch.zeros((capacity,), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.capacity = capacity
        self._alloc_extra(capacity)

    def _alloc_extra(self, capacity: int) -> None:
        """Hook for subclasses holding extra per-slot device tensors."""

    def _grow_extra(self, new_cap: int) -> None:
        """Hook: grow extra per-slot tensors to new_cap."""

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = next_bucket(needed, base=self._initial_capacity, factor=self._growth_factor)
        self.vectors, self.norms, self.valid = (
            grow_rows(t, new_cap) for t in (self.vectors, self.norms, self.valid))
        self._grow_extra(new_cap)
        self._slot_to_id.extend([None] * (new_cap - len(self._slot_to_id)))
        self.capacity = new_cap

    # -- properties ----------------------------------------------------------

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._id_to_slot)

    # -- mutation -------------------------------------------------------------

    def _assign_slots(self, ids: Sequence[str]) -> np.ndarray:
        slots = np.empty(len(ids), dtype=np.int64)
        for i, id_ in enumerate(ids):
            slot = self._id_to_slot.get(id_)
            if slot is None:
                if self._free:
                    slot = self._free.pop()
                else:
                    slot = self._high_water
                    self._high_water += 1
                    self._ensure_capacity(self._high_water)
                self._id_to_slot[id_] = slot
                self._slot_to_id[slot] = id_
            slots[i] = slot
        return slots

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[0] != len(ids):
            raise ValueError("vectors must be [len(ids), dim]")
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        # Dedupe within the batch (last write wins) — index_copy_ with
        # duplicate indices writes in no defined order.
        last: Dict[str, int] = {i: p for p, i in enumerate(ids)}
        if len(last) != len(ids):
            keep = sorted(last.values())
            ids = [ids[p] for p in keep]
            vectors = vectors[keep]
        with self._lock:
            slots = self._assign_slots(ids)
            slots_d = torch.from_numpy(slots).to(self.device)
            # Cast on the device; norms come from the cast rows, so they
            # describe the stored row exactly.
            vecs_d = torch.from_numpy(vectors).to(self.device).to(self.storage_dtype)
            self._write(slots_d, vecs_d, _row_norms(vecs_d))

    def add_batch_device(self, ids: Sequence[str],
                         chunks: Sequence[Tuple[torch.Tensor, int]]) -> None:
        """Write device-resident rows without a host round trip.

        ``chunks`` is ``[(f32 [rows, dim] on this index's device, n_valid),
        ...]`` with ``sum(n_valid) == len(ids)``, the shape
        ``DeviceHashEmbedder.embed_ingest`` hands back. Rows past ``n_valid``
        in a chunk are dropped: only the real rows are written. The caller
        guarantees that ``ids`` are unique within the batch (the db's
        text-only ingest path checks); ``add_batch`` stays the general entry.
        """
        if not len(ids):
            return
        total = sum(nv for _, nv in chunks)
        if total != len(ids):
            raise ValueError(f"chunks carry {total} rows for {len(ids)} ids")
        for dev, _ in chunks:
            if dev.ndim != 2 or dev.shape[1] != self._dim:
                raise DimensionMismatchError(self._dim, dev.shape[-1])
        with self._lock:
            slots = torch.from_numpy(self._assign_slots(ids)).to(self.device)
            off = 0
            for dev, nv in chunks:
                vecs_d = dev[:nv].to(self.device).to(self.storage_dtype)
                self._write(slots[off:off + nv], vecs_d, _row_norms(vecs_d))
                off += nv

    def _write(self, slots: torch.Tensor, vecs: torch.Tensor, norms: torch.Tensor) -> None:
        """Write one batch (slots int64, rows in the storage dtype, f32
        norms) into the device tensors (overridable)."""
        self.vectors.index_copy_(0, slots, vecs)
        self.norms.index_copy_(0, slots, norms)
        self.valid.index_fill_(0, slots, True)

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            slots = [self._id_to_slot.pop(i) for i in ids if i in self._id_to_slot]
            if not slots:
                return 0
            for s in slots:
                self._slot_to_id[s] = None
                self._free.append(s)
            slots_d = torch.as_tensor(slots, dtype=torch.int64).to(self.device)
            self.valid.index_fill_(0, slots_d, False)
            return len(slots)

    def clear(self) -> None:
        with self._lock:
            self._alloc(self._initial_capacity)
            self._id_to_slot.clear()
            self._slot_to_id = [None] * self._initial_capacity
            self._free = []
            self._high_water = 0

    def load_state(self, vectors: Optional[np.ndarray], norms: Optional[np.ndarray],
                   valid: np.ndarray, slot_to_id: Sequence[Optional[str]], free: Sequence[int],
                   high_water: int, **extra) -> None:
        """Take over the device arrays and slot bookkeeping of another flat
        index — e.g. a JAX ``FlatDeviceIndex`` read back with ``np.asarray``
        (its ``vectors``, ``norms``, ``valid``, ``_slot_to_id``, ``_free``
        and ``_high_water``). ``extra`` holds a subclass's extra planes
        (``_load_extra``). JAX hands bf16 back as an ``ml_dtypes`` bfloat16
        array, which torch cannot take, so 2-byte arrays go through their
        uint16 bit pattern. ``vectors`` and ``norms`` are None for a layout
        that keeps no full-precision rows."""
        cap = np.shape(valid)[0]
        if len(slot_to_id) != cap or np.shape(valid) != (cap,):
            raise ValueError("valid and slot_to_id must share the capacity")
        if (vectors is None) != (self.vectors is None) or (vectors is None) != (norms is None):
            raise ValueError("vectors and norms are given exactly when this layout keeps them")
        vecs_t = norms_t = None
        if vectors is not None:
            vectors = np.asarray(vectors)
            if vectors.ndim != 2 or vectors.shape[1] != self._dim:
                raise DimensionMismatchError(self._dim, vectors.shape[-1])
            if vectors.shape[0] != cap or np.shape(norms) != (cap,):
                raise ValueError("vectors, norms and valid must share the capacity")
            # np.array copies: arrays read back from another framework may
            # be read-only, which torch.from_numpy does not take
            if vectors.dtype.itemsize == 2:
                if self.storage_dtype != torch.bfloat16:
                    raise ValueError(f"2-byte vectors need bfloat16 storage, "
                                     f"not {self.storage_dtype}")
                vecs_t = torch.from_numpy(np.array(vectors).view(np.uint16)).view(torch.bfloat16)
            else:
                vecs_t = torch.from_numpy(np.array(vectors, dtype=np.float32)).to(
                    self.storage_dtype)
            vecs_t = vecs_t.to(self.device)
            norms_t = torch.from_numpy(np.array(norms, dtype=np.float32)).to(self.device)
        with self._lock:
            self.vectors, self.norms = vecs_t, norms_t
            self.valid = torch.from_numpy(np.array(valid, dtype=bool)).to(self.device)
            self.capacity = cap
            self._load_extra(cap, **extra)
            self._slot_to_id = list(slot_to_id)
            self._id_to_slot = {i: s for s, i in enumerate(self._slot_to_id) if i is not None}
            self._free = list(free)
            self._high_water = int(high_water)

    def _load_extra(self, capacity: int, **extra) -> None:
        """Hook: take over a subclass's extra planes in ``load_state``."""
        if extra:
            raise TypeError(f"{type(self).__name__}.load_state got unexpected planes "
                            f"{sorted(extra)}")

    # -- search ---------------------------------------------------------------

    def compile_mask(self, allowed_ids) -> np.ndarray:
        """Allowed-id set -> capacity-aligned slot mask for masked top-k."""
        from grape_vector_db_tpu_torch.engine.filtering import mask_from_allowed

        with self._lock:
            return mask_from_allowed(set(allowed_ids), self._slot_to_id,
                                     self._id_to_slot)

    def _exact_topk(self, q: torch.Tensor, mask: Optional[torch.Tensor],
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return scored_topk(q, self.vectors, self.norms, self.valid, k=k, metric=self.metric,
                           chunk=min(_SEARCH_CHUNK, self.capacity), mode=self.search_mode,
                           mask=mask)

    def raw_topk(self, queries: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Device top-k: returns (scores [B, k], slot indices [B, k]) as numpy.
        Rows beyond the true query count must be stripped by the caller.

        Holds the index lock: a write between reading the tensors and the
        scan would mix two states of the index."""
        return self._device_call(lambda q, m: self._exact_topk(q, m, k), queries, mask)

    def search_batch(self, queries: np.ndarray, k: int,
                     mask: Optional[np.ndarray] = None) -> List[List[SearchHit]]:
        with trace_span("index"):
            qp, b = self._padded_queries(queries)
            if qp is None:
                return [[] for _ in range(b)]
            vals, idxs = self.raw_topk(qp, k, mask=mask)
            with trace_span("index.hits"):
                return self.hits_from_slots(vals[:b], idxs[:b])

    def hits_from_slots(self, vals: np.ndarray, idxs: np.ndarray) -> List[List[SearchHit]]:
        """(scores [B, k], slots [B, k]) read back -> per-query hits, leaving
        out entries that are not finite or name a free slot."""
        return hits_from_arrays(vals, idxs, self._slot_to_id)

    # -- introspection / persistence -------------------------------------------

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        slot = self._id_to_slot.get(id_)
        if slot is None:
            return None
        return self.vectors[slot].to(torch.float32).cpu().numpy()

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        with self._lock:
            items = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if not items:
                return [], np.zeros((0, self._dim), dtype=np.float32)
            ids = [i for i, _ in items]
            slots = torch.as_tensor([s for _, s in items], dtype=torch.int64)
            vecs = self.vectors[slots.to(self.device)].to(torch.float32).cpu().numpy()
            return ids, vecs

    def get_stats(self) -> IndexStats:
        bytes_per_row = self.storage_dtype.itemsize * self._dim + 4 + 1
        return IndexStats(
            point_count=len(self._id_to_slot),
            dimension=self._dim,
            capacity=self.capacity,
            is_built=True,
            memory_usage_mb=self.capacity * bytes_per_row / 1e6,
            kind=self.kind,
        )


#: Short name used by the port's docs and tests.
FlatIndex = FlatDeviceIndex

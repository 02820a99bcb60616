"""IvfDeviceIndex — k-means partitioned search with per-query probing.

PyTorch counterpart of ``grape_vector_db_tpu/index/ivf.py``:

- storage: ``[nlist, list_cap, D]`` lists (bf16 by default) plus f32 norms,
  a validity mask and the ``[nlist, list_cap]`` f32 score-weight plane
  ``recip`` (1/|v| for cosine, 1 for dot, 0 = free or deleted), all on
  ``device``; rows are grouped by nearest centroid;
- search: one ``[B, L]`` matmul picks each query's top-``nprobe`` lists, the
  ragged probe (``ops/ivf.py``: a CUDA kernel for CUDA tensors, its plain
  version on the CPU) scores their occupied rows, and the selection maps
  winners back to (list, pos) cells. Euclidean search takes the plain gather
  probe, as the reference's non-kernel path does;
- overflow: lists have a fixed capacity; spill goes to an exact flat index
  (``FlatDeviceIndex``) merged into every answer. ``optimize()`` retrains the
  centroids and repacks everything;
- filters: a mask folds into the probe's selection; the planner sends
  low-selectivity filters to the exhaustive tiers (``ops/ivf_scan.py``).

Writes scatter only the real rows (PyTorch has no "drop" scatter mode for
padding slots).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.device_call import DeviceCalls
from grape_vector_db_tpu_torch.index.flat import _STORAGE_DTYPES, FlatDeviceIndex, _row_norms
from grape_vector_db_tpu_torch.index.hits import hits_from_arrays, merge_hits
from grape_vector_db_tpu_torch.ops.distance import prepare_queries
from grape_vector_db_tpu_torch.ops.ivf import (NEG_INF, _pad_k, ivf_topk, make_recip,
                                               nblocks_from_counts)
from grape_vector_db_tpu_torch.ops.kmeans import assign_clusters, kmeans
from grape_vector_db_tpu_torch.utils.buckets import next_bucket
from grape_vector_db_tpu_torch.utils.tracing import trace_span

__all__ = ["IvfDeviceIndex"]

# Rows gathered per step when reading cells back to the host.
_READ_ROWS = 65536


def _from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array read back from another framework -> tensor on device.
    np.array copies (such arrays may be read-only); a 2-byte float array
    (JAX's ml_dtypes bfloat16) goes through its uint16 bit pattern."""
    a = np.array(a)
    if str(a.dtype) == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _gather_topk(queries, centroids, vecs, norms, valid, k: int, nprobe: int,
                 metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain gather probe (the reference's ``_ivf_topk``, its path without the
    kernel), used for euclidean: top-nprobe lists by centroid affinity, the
    probed rows gathered and scored, top-k over (list, pos) cells."""
    b = queries.shape[0]
    l, c, _ = vecs.shape
    q = prepare_queries(queries, metric)
    cq = q @ centroids.T
    if metric == "euclidean":
        c2 = torch.sum(centroids * centroids, dim=-1)[None, :]
        cq = -(torch.sum(q * q, dim=-1, keepdim=True) - 2 * cq + c2)
    _, probe = torch.topk(cq, min(nprobe, l), dim=1)                  # [B, P]
    cand = vecs[probe].to(torch.float32)                               # [B, P, C, D]
    qc = q.to(vecs.dtype).to(torch.float32)
    dots = torch.einsum("bd,bpcd->bpc", qc, cand)
    cn = norms[probe]
    if metric == "cosine":
        scores = torch.clamp(dots / torch.clamp(cn, min=1e-12), max=1.0)
    elif metric == "dot":
        scores = dots
    else:
        q_sq = torch.sum(q * q, dim=-1)[:, None, None]
        scores = -(q_sq - 2.0 * dots + cn * cn)
    scores = torch.where(valid[probe], scores, NEG_INF)
    p = probe.shape[1]
    pos = torch.arange(c, device=vecs.device)
    gslot = (probe[:, :, None] * c + pos[None, None, :]).reshape(b, p * c)
    vals, idx = torch.topk(scores.reshape(b, p * c), min(k, p * c), dim=1)
    return _pad_k(vals, torch.gather(gslot, 1, idx), k)


class IvfDeviceIndex(DeviceCalls, VectorIndex):
    kind = "ivf"
    supports_mask = True
    # A probe visits nprobe lists; a mask folded into it is exact only over
    # those lists. The planner routes around this at low selectivity.
    mask_exact = False
    supports_exhaustive_mask = True

    def __init__(
        self,
        dimension: int,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        initial_capacity: int = 4096,
        growth_factor: int = 2,
        nlist: int = 64,
        nprobe: int = 8,
        train_size: int = 50_000,
        kmeans_iters: int = 10,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        use_pallas: bool = True,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cosine", "dot", "euclidean"):
            raise ValueError(f"unknown metric {metric}")
        if storage_dtype not in _STORAGE_DTYPES:
            raise ValueError(f"storage_dtype {storage_dtype!r} is not ported; "
                             f"use one of {sorted(_STORAGE_DTYPES)}")
        self._dim = dimension
        self.metric = metric
        if metric not in ("cosine", "dot"):
            # the exhaustive tiers score weighted dots only; euclidean
            # filters take the in-probe mask and the planner's host tier
            self.supports_exhaustive_mask = False
        self.storage_dtype = _STORAGE_DTYPES[storage_dtype]
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.train_size = train_size
        self.kmeans_iters = kmeans_iters
        self.device = torch.device(device)
        self._init_device_calls()
        # list capacity starts small and doubles on overflow pressure; kept
        # a multiple of 128 as in the reference, so both spill alike
        self.list_cap = max(128, next_bucket(initial_capacity // max(nlist, 1), base=128))
        self.centroids: Optional[torch.Tensor] = None  # [L, D] f32
        self._alloc_lists(self.list_cap)
        # Overflow region: exact flat index holding spill until optimize().
        self._overflow = FlatDeviceIndex(
            dimension, metric=metric, storage_dtype=storage_dtype,
            initial_capacity=1024, growth_factor=growth_factor,
            search_mode=search_mode, recall_target=recall_target, device=self.device)
        self._id_to_cell: Dict[str, Tuple[int, int]] = {}
        self._next_pos = np.zeros(nlist, dtype=np.int64)
        self._nblocks_cache: Optional[torch.Tensor] = None  # [L] int32; reset when _next_pos moves
        self._free: List[List[int]] = [[] for _ in range(nlist)]
        self.overflow_merge_rows = 0   # result rows the overflow's hits were merged into
        # Compact filter tier: one-entry cache of the gathered allowed rows,
        # keyed by the write epoch and the allowed cells' bytes.
        self._mutation_epoch = 0
        self._compact_cache = None

    def _zeros(self, shape, dtype: torch.dtype):
        """A zero plane of the layout (subclass seam: the sharded layout
        splits every plane over its shards)."""
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _alloc(self, cap: int) -> None:
        l, d = self.nlist, self._dim
        self.vecs = self._zeros((l, cap, d), self.storage_dtype)
        self.norms = self._zeros((l, cap), torch.float32)
        self.valid = self._zeros((l, cap), torch.bool)
        self.recip: Optional[torch.Tensor] = self._zeros((l, cap), torch.float32)

    def _alloc_lists(self, cap: int) -> None:
        """Empty lists of capacity ``cap`` (the planes through the ``_alloc``
        seam, which may round ``list_cap``) and their id table: the ids by
        cell ``list * list_cap + pos``, None where empty, read by one gather
        a search."""
        self._alloc(cap)
        self._cell_ids: List[Optional[str]] = [None] * (self.nlist * self.list_cap)

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._id_to_cell) + len(self._overflow)

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    # -- training ---------------------------------------------------------------

    @property
    def _kmeans_mode(self) -> str:
        # Spherical k-means for angular metrics: L2 Lloyd's on near-isotropic
        # high-dim data collapses onto the smallest-norm centroid.
        return "spherical" if self.metric in ("cosine", "dot") else "l2"

    def _auto_train_threshold(self) -> int:
        """Corpus size that triggers auto-training on insert."""
        return self.nlist * 4

    def train(self, sample: np.ndarray, seed: int = 0) -> None:
        """Fit centroids on (a seeded subsample of) ``sample``."""
        sample = np.asarray(sample, dtype=np.float32)
        if sample.shape[0] < self.nlist:
            raise ValueError(f"need >= nlist={self.nlist} training points")
        if sample.shape[0] > self.train_size:
            sel = np.random.default_rng(seed).choice(
                sample.shape[0], self.train_size, replace=False)
            sample = sample[sel]
        # Cap the update's [N, nlist] plane at ~256 MB f32 with the chunked
        # Lloyd scan (the reference's rule, so both train on the same rows).
        chunk = None
        if sample.shape[0] * self.nlist > (1 << 26):
            chunk = max(256, (1 << 26) // self.nlist)
            n_use = max((sample.shape[0] // chunk) * chunk, min(chunk, sample.shape[0]))
            sample = sample[:n_use]
            if sample.shape[0] % chunk:
                chunk = sample.shape[0]
        cents, _ = kmeans(torch.from_numpy(sample).to(self.device), k=self.nlist,
                          iters=self.kmeans_iters, seed=seed, mode=self._kmeans_mode,
                          chunk=chunk)
        self.centroids = cents

    # -- mutation -----------------------------------------------------------------

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        with self._lock:
            # Remove any existing versions first (upsert semantics).
            existing = [i for i in ids if i in self._id_to_cell or self._overflow.contains(i)]
            if existing:
                self.remove_batch(existing)
            if self.centroids is None:
                if len(self) + len(ids) >= self._auto_train_threshold():
                    # Auto-train on the first big enough batch (+ overflow backlog).
                    o_ids, o_vecs = self._overflow.get_all()
                    pool = np.concatenate([o_vecs, vectors]) if len(o_ids) else vectors
                    self.train(pool)
                    if o_ids:
                        self._overflow.clear()
                        self._place(o_ids, o_vecs)
                else:
                    self._overflow.add_batch(ids, vectors)
                    return
            self._place(list(ids), vectors)

    def _place(self, ids: List[str], vectors: np.ndarray) -> None:
        vt = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32)).to(self.device)
        assign = assign_clusters(vt, self.centroids, mode=self._kmeans_mode).cpu().numpy()
        list_ids = np.empty(len(ids), dtype=np.int64)
        positions = np.empty(len(ids), dtype=np.int64)
        spill_idx: List[int] = []
        for i, (id_, lst) in enumerate(zip(ids, assign)):
            lst = int(lst)
            if self._free[lst]:
                pos = self._free[lst].pop()
            elif self._next_pos[lst] < self.list_cap:
                # _next_pos counts occupancy; _phys_pos maps the logical
                # insert order to a column (the sharded index stripes it)
                pos = self._phys_pos(int(self._next_pos[lst]))
                self._next_pos[lst] += 1
            else:
                spill_idx.append(i)
                list_ids[i] = -1
                positions[i] = -1
                continue
            list_ids[i] = lst
            positions[i] = pos
            self._id_to_cell[id_] = (lst, pos)
            self._cell_ids[lst * self.list_cap + pos] = id_
        self._nblocks_cache = None  # _next_pos may have advanced
        self._mutation_epoch += 1
        keep = np.flatnonzero(list_ids >= 0)
        if len(keep):
            rows = torch.from_numpy(keep).to(self.device)
            # norms come from the rows cast to the storage dtype, so they
            # describe the stored row exactly
            vecs_d = vt[rows].to(self.storage_dtype)
            lists_d = torch.from_numpy(list_ids[keep]).to(self.device)
            pos_d = torch.from_numpy(positions[keep]).to(self.device)
            self._scatter_rows(lists_d, pos_d, vecs_d, _row_norms(vecs_d))
            self._post_scatter(lists_d, pos_d, vecs_d)
        if spill_idx:
            self._overflow.add_batch([ids[i] for i in spill_idx], vectors[spill_idx])

    def _phys_pos(self, n: int) -> int:
        """Logical insert order -> column of a list (subclass seam: the
        sharded layout stripes rows over its shards)."""
        return n

    def _weights(self, norms: torch.Tensor) -> torch.Tensor:
        """Score weight of live rows: 1/|v| for cosine, 1 for dot."""
        if self.metric == "cosine":
            return 1.0 / torch.clamp(norms, min=1e-12)
        return torch.ones_like(norms)

    def _scatter_rows(self, lists, pos, vecs, norms) -> None:
        """Device scatter of placed rows (subclass seam: quantized layouts
        store codes instead of, or beside, the bf16 plane)."""
        self.vecs[lists, pos] = vecs.to(self.storage_dtype)
        self.norms[lists, pos] = norms
        self.valid[lists, pos] = True
        self.recip[lists, pos] = self._weights(norms)

    def _post_scatter(self, lists, pos, vecs) -> None:
        """Hook after ``_scatter_rows``: planes a subclass derives from the
        placed rows (IVF-PQ's codes)."""

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            cells = []
            n = 0
            for i in ids:
                cell = self._id_to_cell.pop(i, None)
                if cell is not None:
                    lst, pos = cell
                    self._free[lst].append(pos)
                    self._cell_ids[lst * self.list_cap + pos] = None
                    cells.append(cell)
                    n += 1
            n += self._overflow.remove_batch([i for i in ids if i not in self._id_to_cell])
            if cells:
                arr = torch.as_tensor(cells, dtype=torch.int64).to(self.device)
                self._invalidate_cells(arr[:, 0], arr[:, 1])
            return n

    def _invalidate_cells(self, lists, pos) -> None:
        """Device invalidation of removed cells (subclass seam)."""
        self._mutation_epoch += 1
        self.valid[lists, pos] = False
        if self.recip is not None:
            self.recip[lists, pos] = 0.0

    def clear(self) -> None:
        with self._lock:
            self.centroids = None
            self._alloc_lists(self.list_cap)
            self._overflow.clear()
            self._id_to_cell.clear()
            self._next_pos = np.zeros(self.nlist, dtype=np.int64)
            self._nblocks_cache = None
            self._mutation_epoch += 1
            self._compact_cache = None
            self._free = [[] for _ in range(self.nlist)]

    def load_state(self, *, centroids, norms, valid, list_cap: int, next_pos,
                   free: Sequence[Sequence[int]], id_to_cell: Dict[str, Tuple[int, int]],
                   vecs=None, recip=None, overflow: Optional[dict] = None) -> None:
        """Take over the state of a JAX ``IvfDeviceIndex`` read back with
        ``np.asarray``: its ``centroids``, ``vecs``, ``norms``, ``valid``,
        ``recip`` (``[L, C]``, or the reference's ``[L, 8, C]``), ``list_cap``,
        ``_next_pos``, ``_free`` and ``_id_to_cell``; ``overflow`` holds the
        keyword arguments of ``FlatDeviceIndex.load_state`` for the overflow
        region. The centroids must be set (a trained index)."""
        dev = self.device
        with self._lock:
            self.list_cap = int(list_cap)
            self.centroids = _from_numpy(centroids, torch.float32, dev)
            self.norms = _from_numpy(norms, torch.float32, dev)
            self.valid = _from_numpy(valid, torch.bool, dev)
            shape = (self.nlist, self.list_cap)
            if tuple(self.norms.shape) != shape or tuple(self.valid.shape) != shape:
                raise ValueError(f"norms and valid must be {shape}")
            self.vecs = None if vecs is None else _from_numpy(vecs, self.storage_dtype, dev)
            if recip is not None:
                recip = np.asarray(recip)
                self.recip = _from_numpy(recip[:, 0, :] if recip.ndim == 3 else recip,
                                         torch.float32, dev)
            elif self.vecs is not None:
                # the reference keeps no plane where its kernel is off
                # (euclidean); the port keeps one beside every bf16 layout
                self.recip = make_recip(self.norms, self.valid, self.metric)
            else:
                self.recip = None
            self._next_pos = np.array(next_pos, dtype=np.int64)
            self._free = [list(map(int, f)) for f in free]
            self._id_to_cell = {i: (int(l), int(p)) for i, (l, p) in id_to_cell.items()}
            self._cell_ids = [None] * (self.nlist * self.list_cap)
            for i, (l, p) in self._id_to_cell.items():
                self._cell_ids[l * self.list_cap + p] = i
            self._nblocks_cache = None
            self._mutation_epoch += 1
            self._compact_cache = None
            if overflow is not None:
                self._overflow.load_state(**overflow)

    # -- search -------------------------------------------------------------------

    def compile_mask(self, allowed_ids):
        """Allowed ids -> ([nlist, list_cap] cell mask, overflow slot mask)."""
        with self._lock:
            main = np.zeros((self.nlist, self.list_cap), dtype=bool)
            for id_ in allowed_ids:
                cell = self._id_to_cell.get(id_)
                if cell is not None:
                    main[cell[0], cell[1]] = True
            return main, self._overflow.compile_mask(allowed_ids)

    def _nblocks(self) -> torch.Tensor:
        """Per-list occupied 64-row blocks (the probe skips rows past each
        list's high-water mark). Cached on the device: _next_pos only moves
        in _place, clear, optimize and load_state."""
        if self._nblocks_cache is None:
            self._nblocks_cache = nblocks_from_counts(self._next_pos, device=self.device)
        return self._nblocks_cache

    def _mask_tensor(self, mask) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return torch.from_numpy(np.asarray(mask[0], dtype=bool)).to(self.device)

    def _main_topk(self, qp: torch.Tensor, k: int, mask, nprobe=None):
        """Top-k over the bucketed main region (subclass seam; lock held).
        ``nprobe`` is the per-request override (SearchParams.ef)."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        cm = self._mask_tensor(mask)
        if self.metric in ("cosine", "dot"):
            return ivf_topk(qp, self.centroids, self.vecs, self.recip, k=k, nprobe=nprobe,
                            metric=self.metric, cell_mask=cm, nblocks=self._nblocks())
        valid = self.valid if cm is None else self.valid & cm
        return _gather_topk(qp, self.centroids, self.vecs, self.norms, valid, k, nprobe,
                            self.metric)

    def _scan_planes(self):
        """(data, weight plane, format) for the exhaustive tiers: the arrays
        the probe kernel reads (subclass seam)."""
        return self.vecs, self.recip, "bf16"

    # Device-memory budget for the compact tier's gathered row copy (the
    # streaming tier allocates none).
    compact_max_bytes = 1 << 30

    def _exhaustive_topk(self, qp: torch.Tensor, k: int, mask):
        """Exact masked top-k over every list. The compact tier (gather the
        allowed rows once, scan those) serves allowed sets whose rows fit
        ``compact_max_bytes``; larger ones take the streaming tier (one pass
        over every list, then a k-list probe)."""
        from grape_vector_db_tpu_torch.ops.ivf_scan import (
            compact_gather, compact_topk_from_rows, default_chunk_lists,
            ivf_exhaustive_masked_topk)

        data, plane, fmt = self._scan_planes()
        m = np.asarray(mask[0], dtype=bool)
        r = int(m.sum())
        cdata, cplane, cfmt = data, plane, fmt
        if fmt != "bf16" and self.vecs is not None:
            # a quantized kind keeping a bf16 shadow gathers full-precision
            # rows: the compact tier's scores are exact, not quantized
            cdata, cplane, cfmt = (self.vecs, make_recip(self.norms, self.valid, self.metric),
                                   "bf16")
        row_bytes = int(np.prod(cdata.shape[2:])) * cdata.element_size()
        if r > 0 and r * row_bytes <= self.compact_max_bytes:
            cells = np.flatnonzero(m.reshape(-1))
            # Keyed by the cells' bytes (never by a hash of them) and the
            # write epoch: any write, delete, optimize or clear invalidates.
            key = (self._mutation_epoch, cfmt, cells.tobytes())
            cached = self._compact_cache
            if cached is not None and cached[0] == key:
                _, cells_d, rows, w = cached
            else:
                self._compact_cache = None   # free the old block before the gather
                cells_d = torch.from_numpy(cells).to(self.device)
                rows, w = compact_gather(cdata, cplane, cells_d)
                self._compact_cache = (key, cells_d, rows, w)
            return compact_topk_from_rows(qp, rows, w, cells_d, k=k, metric=self.metric,
                                          fmt=cfmt, chunk_rows=min(131_072, r))
        return ivf_exhaustive_masked_topk(
            qp, data, plane, self._mask_tensor(mask), k=k, metric=self.metric, fmt=fmt,
            chunk_lists=default_chunk_lists(self.nlist, data.shape[1]),
            nblocks=self._nblocks())

    def counters(self) -> Dict[str, float]:
        """The device-call counters, and the result rows into which the
        overflow region's hits were merged."""
        return {**super().counters(),
                "ivf_overflow_merge_rows_total": float(self.overflow_merge_rows)}

    def _hits(self, vals: np.ndarray, slots: np.ndarray, cell_ids: List[Optional[str]],
              o_hits: List[List[SearchHit]], k: int) -> List[List[SearchHit]]:
        """The main region's read-back (scores, cells) -> hits through the
        id table ``cell_ids``, with the overflow region's hits merged into
        the rows that have any."""
        out = hits_from_arrays(vals, slots, cell_ids)
        self.overflow_merge_rows += merge_hits(out, o_hits, k)
        return out

    def search_batch(self, queries: np.ndarray, k: int, mask=None, nprobe=None,
                     exhaustive: bool = False) -> List[List[SearchHit]]:
        """Top-k of each query over the probed lists and the overflow region.
        The spans of ``FlatDeviceIndex``'s search: ``index`` around the
        call, the main region's device call (``index.launch`` enqueueing the
        probe and the selection, ``index.readback``), ``index.hits``."""
        with trace_span("index"):
            qp, b = self._padded_queries(queries)
            if qp is None:
                return [[] for _ in range(b)]
            o_mask = None if mask is None else mask[1]
            with self._search_lock():
                if self.centroids is None:
                    o_vals, o_idx = self._overflow.raw_topk(qp, k, mask=o_mask)
                    with trace_span("index.hits"):
                        return self._overflow.hits_from_slots(o_vals[:b], o_idx[:b])
                if exhaustive and mask is not None and self.supports_exhaustive_mask:
                    vals, slots = self._device_call(
                        lambda q, _: self._exhaustive_topk(q, k, mask), qp, rows=b)
                else:
                    vals, slots = self._device_call(
                        lambda q, _: self._main_topk(q, k, mask, nprobe=nprobe), qp, rows=b)
                o_hits = []
                if len(self._overflow):
                    o_vals, o_idx = self._overflow.raw_topk(qp, k, mask=o_mask)
                    with trace_span("index.hits"):
                        o_hits = self._overflow.hits_from_slots(o_vals[:b], o_idx[:b])
                # the table the cells index (optimize and clear replace it)
                cell_ids = self._cell_ids
            with trace_span("index.hits"):
                return self._hits(vals, slots, cell_ids, o_hits, k)

    # -- maintenance ----------------------------------------------------------------

    def tune_nprobe(self, queries: Optional[np.ndarray] = None, k: int = 10,
                    target_recall: float = 0.95,
                    max_nprobe: Optional[int] = None) -> int:
        """Pick (and set) the smallest nprobe whose recall@k on a validation
        query set meets ``target_recall``, against this index's own
        exhaustive probe (nprobe = nlist). ``queries`` defaults to a sample
        of the indexed vectors (the self-recall protocol); candidates double."""
        with self._lock:
            if self.centroids is None or not self._id_to_cell:
                return self.nprobe
            if queries is None:
                ids = list(self._id_to_cell)[:256]
                queries = np.stack([self._host_row(*self._id_to_cell[i]) for i in ids])
        queries = np.asarray(queries, dtype=np.float32)
        limit = min(max_nprobe or self.nlist, self.nlist)
        saved = self.nprobe
        chosen: Optional[int] = None
        try:
            self.nprobe = self.nlist
            oracle = [frozenset(h[0] for h in row) for row in self.search_batch(queries, k)]
            denom = sum(len(w) for w in oracle) or 1
            cand = 1
            while True:
                self.nprobe = cand
                got = self.search_batch(queries, k)
                hits = sum(len(set(h[0] for h in row) & want)
                           for row, want in zip(got, oracle))
                if hits / denom >= target_recall or cand >= limit:
                    chosen = cand
                    return cand
                cand = min(cand * 2, limit)
        finally:
            self.nprobe = chosen if chosen is not None else saved

    def optimize(self) -> None:
        """Retrain centroids on the whole corpus and repack every list
        (absorbs the overflow region)."""
        with self._lock:
            ids, vecs = self.get_all()
            if len(ids) < self.nlist:
                return
            self.clear()
            self.train(vecs)
            # Size lists to the retrained cluster histogram (with 25%
            # headroom) so the repack absorbs the whole corpus.
            counts = np.bincount(
                assign_clusters(torch.from_numpy(vecs).to(self.device), self.centroids,
                                mode=self._kmeans_mode).cpu().numpy(),
                minlength=self.nlist)
            need = int(counts.max())
            if need > self.list_cap:
                self.list_cap = next_bucket(int(need * 1.25) + 1, base=128)
                self._alloc_lists(self.list_cap)
            self._place(ids, vecs)

    # -- introspection ---------------------------------------------------------------

    def _rows_at(self, lists: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """f32 rows of the given cells, on the device (subclass seam:
        code-resident layouts dequantize here)."""
        return self.vecs[lists, pos].to(torch.float32)

    def _host_rows(self, lists: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Host f32 [n, D] read of cells, gathered on the device in steps."""
        out = np.empty((len(lists), self._dim), dtype=np.float32)
        for off in range(0, len(lists), _READ_ROWS):
            lt = torch.from_numpy(lists[off:off + _READ_ROWS]).to(self.device)
            pt = torch.from_numpy(pos[off:off + _READ_ROWS]).to(self.device)
            out[off:off + _READ_ROWS] = self._rows_at(lt, pt).cpu().numpy()
        return out

    def _host_row(self, lst: int, pos: int) -> np.ndarray:
        return self._host_rows(np.array([lst]), np.array([pos]))[0]

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        cell = self._id_to_cell.get(id_)
        if cell is None:
            return self._overflow.get_vector(id_)
        return self._host_row(*cell)

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        with self._lock:
            cells = sorted(self._id_to_cell.items(), key=lambda kv: kv[1])
            ids = [i for i, _ in cells]
            arr = np.asarray([c for _, c in cells], dtype=np.int64).reshape(-1, 2)
            main = self._host_rows(arr[:, 0], arr[:, 1])
            o_ids, o_vecs = self._overflow.get_all()
            ids.extend(o_ids)
            return ids, np.concatenate([main, o_vecs], axis=0)

    def get_stats(self) -> IndexStats:
        fill = [int(self._next_pos[i]) - len(self._free[i]) for i in range(self.nlist)]
        return IndexStats(
            point_count=len(self),
            dimension=self._dim,
            capacity=self.nlist * self.list_cap,
            kind=self.kind,
            is_built=self.is_trained,
            memory_usage_mb=self.nlist * self.list_cap
            * (self.storage_dtype.itemsize * self._dim + 5) / 1e6,
            extra={
                "nlist": float(self.nlist),
                "nprobe": float(self.nprobe),
                "overflow": float(len(self._overflow)),
                "max_list_fill": float(max(fill) if fill else 0),
            },
        )

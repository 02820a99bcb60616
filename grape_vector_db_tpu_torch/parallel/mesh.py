"""Corpus sharding over a device mesh, driven by one process.

PyTorch counterpart of ``grape_vector_db_tpu/parallel/mesh.py``. The
reference runs one SPMD program over a ``jax.sharding.Mesh``: ``shard_map``
runs every device's body, and one ``all_gather`` merges their winners. Here
one Python process drives a grid of devices, as the reference's single
controller does:

- a ``Mesh`` is an ndarray of ``torch.device`` with axis names;
- a sharded operand is a ``ShardedTensor``: one logical tensor split along
  one axis into equal parts, part ``s`` on the devices of shard ``s`` (one
  copy a distinct device: on a 2-D mesh each replica row holds the corpus);
- each shard's local top-k runs on its own device through the single-device
  routes: B1 (k >= 4) or B2 (k <= 3) above 262,144 rows a shard
  (``ops/segmax.py``), B3 / B4 / B5 for the IVF probes (``ops/ivf.py``);
- ``all_gather`` becomes a copy of every shard's [B, k] winners to the mesh's
  first device, concatenated in shard order, and one ``ops/topk.take_topk``
  (``lax.top_k``'s tie rule); ``lax.pmax`` an elementwise max there.

A mesh may name a device more than once, where the reference's devices are
distinct: ``make_mesh(n_shards=8, devices=[cpu])`` repeats the one CPU, as
the reference's tests run 8 virtual CPU devices, and one card serves a
4-shard mesh. Shards on one device run one after another on its stream.

The global slot of a flat row is ``local + shard * shard_capacity``; of an
IVF cell ``list * C + shard * C/S + local column``, where ``C`` is the list
capacity and each shard holds ``C/S`` columns of every list.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.flat import _STORAGE_DTYPES, _row_norms, ship_batch
from grape_vector_db_tpu_torch.index.hits import hits_from_arrays
from grape_vector_db_tpu_torch.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int4 import Int4IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int8 import Int8IvfDeviceIndex
from grape_vector_db_tpu_torch.ops import distance
from grape_vector_db_tpu_torch.ops.distance import chunked_topk, prepare_queries, score_block
from grape_vector_db_tpu_torch.ops.ivf import (NEG_INF, ivf_probe_scores, ivf_probe_scores_int4,
                                               ivf_probe_scores_int8, make_factor,
                                               nblocks_from_counts)
from grape_vector_db_tpu_torch.ops.ivf_scan import (_PROBES, _dequant, compact_scan_core,
                                                    default_chunk_lists, probe_dup_mask)
from grape_vector_db_tpu_torch.ops.topk import take_topk
from grape_vector_db_tpu_torch.utils.buckets import next_bucket, pad_rows

__all__ = ["Mesh", "ShardedTensor", "local_devices", "make_mesh", "make_mesh_2d",
           "replicated_sharded_topk", "sharded_scored_topk", "sharded_ivf_topk",
           "sharded_ivf_int8_topk", "sharded_ivf_exhaustive_topk",
           "sharded_ivf_compact_topk", "ShardedInt8IvfIndex", "ShardedInt4IvfIndex",
           "ShardedFlatIndex", "ShardedIvfIndex"]

# Rows a write or a readback moves to or from the device at a time.
_STEP_ROWS = 65536


# -- the mesh ----------------------------------------------------------------------


class Mesh:
    """A grid of devices with axis names: ``devices`` is an ndarray of
    ``torch.device``, ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != len(axis_names):
            raise ValueError(f"a {devs.ndim}-D device grid needs {devs.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = np.empty(devs.shape, dtype=object)
        for pos, d in np.ndenumerate(devs):
            self.devices[pos] = _device(d)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def local_devices(device: str | torch.device = "cuda") -> List[torch.device]:
    """The devices of this host a mesh may use: every CUDA device for a
    CUDA ``device``, else ``[device]`` (the counterpart of
    ``jax.local_devices()``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _cycle(devices, n: int) -> List[torch.device]:
    devs = [_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return [devs[i % len(devs)] for i in range(n)]


def make_mesh(
    n_shards: Optional[int] = None,
    shard_axis: str = "shard",
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A 1-D mesh of ``n_shards`` entries (default: one a device). Where
    ``n_shards`` exceeds the devices given, they repeat in turn."""
    devs = list(devices) if devices is not None else local_devices("cuda")
    n = len(devs) if n_shards is None else n_shards
    return Mesh(_cycle(devs, n), (shard_axis,))


def make_mesh_2d(
    n_replicas: int,
    n_shards: Optional[int] = None,
    replica_axis: str = "replica",
    shard_axis: str = "shard",
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """(replica, shard) mesh: the corpus shards over ``shard`` and is
    replicated over ``replica``; the query batch splits over ``replica``.
    Devices repeat in turn where the mesh has more entries than devices."""
    devs = list(devices) if devices is not None else local_devices("cuda")
    total = len(devs) if n_shards is None else n_replicas * n_shards
    if total % n_replicas:
        raise ValueError(f"{total} devices not divisible by {n_replicas} replicas")
    grid = np.empty(total, dtype=object)
    grid[:] = _cycle(devs, total)
    return Mesh(grid.reshape(n_replicas, total // n_replicas), (replica_axis, shard_axis))


def _grid(mesh: Mesh, shard_axis: str) -> np.ndarray:
    """The mesh's devices as [rows, shards]: one row a replica (one row on a
    1-D mesh)."""
    if shard_axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} lack the shard axis {shard_axis!r}")
    d = np.moveaxis(mesh.devices, mesh.axis_names.index(shard_axis), -1)
    return d.reshape(-1, d.shape[-1])


def _home(mesh: Mesh) -> torch.device:
    """The mesh's first device: where merges and host transfers happen."""
    return mesh.devices.flat[0]


# -- sharded tensors ----------------------------------------------------------------


class ShardedTensor:
    """One logical tensor split along ``axis`` into ``S`` equal parts over a
    mesh's shard axis: ``part(s, r)`` is shard s of replica row r, on the
    mesh's device there. Replica rows on the same device share one tensor.

    Indexing speaks global positions: ``t[idx] = v`` (``axis`` 0) or
    ``t[lists, pos] = v`` (``axis`` 1) writes every copy of the shards the
    positions fall in, ``t[idx]`` / ``t[lists, pos]`` gathers on the mesh's
    first device. ``np.asarray(t)`` is the whole tensor on the host (bf16 as
    f32)."""

    def __init__(self, mesh: Mesh, shard_axis: str, axis: int,
                 parts: List[List[torch.Tensor]]):
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.axis = axis
        self.parts = parts
        p = parts[0][0]
        self.local = p.shape[axis]
        self.n_shards = len(parts[0])
        self.shape = tuple(p.shape[:axis]) + (self.local * self.n_shards,) + tuple(
            p.shape[axis + 1:])
        self.dtype = p.dtype
        self.home = _home(mesh)

    @classmethod
    def build(cls, mesh: Mesh, shard_axis: str, axis: int,
              make: Callable[[int, torch.device], torch.Tensor]) -> "ShardedTensor":
        """``make(s, device)`` once for each shard and distinct device."""
        grid = _grid(mesh, shard_axis)
        made: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        parts = []
        for r in range(grid.shape[0]):
            row = []
            for s in range(grid.shape[1]):
                key = (s, grid[r, s])
                if key not in made:
                    made[key] = make(s, grid[r, s])
                row.append(made[key])
            parts.append(row)
        return cls(mesh, shard_axis, axis, parts)

    @classmethod
    def zeros(cls, mesh: Mesh, shard_axis: str, shape, dtype: torch.dtype,
              axis: int = 0) -> "ShardedTensor":
        n = mesh.shape[shard_axis]
        if shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(shape)} does not split over {n} shards")
        local = tuple(shape[:axis]) + (shape[axis] // n,) + tuple(shape[axis + 1:])
        return cls.build(mesh, shard_axis, axis,
                         lambda s, dev: torch.zeros(local, dtype=dtype, device=dev))

    @classmethod
    def from_global(cls, mesh: Mesh, shard_axis: str, t, axis: int = 0) -> "ShardedTensor":
        """Split a whole tensor (or array) into the mesh's shards (copies)."""
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        n = mesh.shape[shard_axis]
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split over {n} shards")
        local = t.shape[axis] // n
        return cls.build(mesh, shard_axis, axis, lambda s, dev: t.narrow(
            axis, s * local, local).to(dev, copy=True).contiguous())

    def part(self, s: int, r: int = 0) -> torch.Tensor:
        return self.parts[r][s]

    def copies(self, s: int) -> List[torch.Tensor]:
        """The distinct tensors holding shard s."""
        out: List[torch.Tensor] = []
        for row in self.parts:
            if not any(row[s] is t for t in out):
                out.append(row[s])
        return out

    def logical_and(self, other: "ShardedTensor") -> "ShardedTensor":
        """Elementwise AND with a tensor split alike."""
        done: Dict[Tuple[int, int], torch.Tensor] = {}
        parts = []
        for ra, rb in zip(self.parts, other.parts):
            row = []
            for a, b in zip(ra, rb):
                if (id(a), id(b)) not in done:
                    done[id(a), id(b)] = a & b.to(a.device)
                row.append(done[id(a), id(b)])
            parts.append(row)
        return ShardedTensor(self.mesh, self.shard_axis, self.axis, parts)

    def _split(self, key):
        """(shard, positions in the key, the shard's local key) for each
        shard the key's positions along ``axis`` fall in."""
        key = tuple(torch.as_tensor(k, device=self.home).reshape(-1).to(torch.int64)
                    for k in (key if isinstance(key, tuple) else (key,)))
        idx = key[self.axis]
        shard = torch.div(idx, self.local, rounding_mode="floor")
        loc = idx - shard * self.local
        local_key = tuple(loc if i == self.axis else k for i, k in enumerate(key))
        if self.n_shards == 1:
            yield 0, None, local_key
            return
        for s in torch.unique(shard).tolist():
            sel = torch.nonzero(shard == s).squeeze(1)
            yield s, sel, tuple(k[sel] for k in local_key)

    def __setitem__(self, key, value) -> None:
        for s, sel, lk in self._split(key):
            v = value
            if isinstance(v, torch.Tensor) and v.dim() > 0 and sel is not None:
                v = v[sel.to(v.device)]
            for t in self.copies(s):
                t[tuple(k.to(t.device) for k in lk)] = (
                    v.to(t.device) if isinstance(v, torch.Tensor) else v)

    def __getitem__(self, key) -> torch.Tensor:
        nkey = len(key) if isinstance(key, tuple) else 1
        first = key[0] if isinstance(key, tuple) else key
        n = torch.as_tensor(first).numel()
        tail = tuple(self.parts[0][0].shape[nkey:])
        out = torch.empty((n,) + tail, dtype=self.dtype, device=self.home)
        for s, sel, lk in self._split(key):
            t = self.parts[0][s]
            got = t[tuple(k.to(t.device) for k in lk)].to(self.home)
            if sel is None:
                out.copy_(got)
            else:
                out[sel] = got
        return out

    def to_global(self, device="cpu") -> torch.Tensor:
        """The whole tensor on ``device`` (replica row 0's parts)."""
        return torch.cat([p.to(device) for p in self.parts[0]], dim=self.axis)

    def __array__(self, dtype=None, copy=None):
        t = self.to_global("cpu")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        a = t.numpy()
        return a if dtype is None else a.astype(dtype)


def _as_sharded(x, mesh: Mesh, shard_axis: str, axis: int) -> Optional[ShardedTensor]:
    """A sharded operand: a ``ShardedTensor`` as it is, a whole tensor or
    array split over the mesh (the reference's global arrays)."""
    if x is None or isinstance(x, ShardedTensor):
        return x
    return ShardedTensor.from_global(mesh, shard_axis, x, axis)


def _pad_k(vals: torch.Tensor, slots: torch.Tensor, k: int):
    got = vals.shape[1]
    if got >= k:
        return vals, slots
    vals = torch.nn.functional.pad(vals, (0, k - got), value=NEG_INF)
    slots = torch.nn.functional.pad(slots, (0, k - got), value=0)
    return vals, slots


def _spmd(queries, mesh: Mesh, shard_axis: str, replica_axis: Optional[str], k: int,
          body) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``body(r, s, q, cache)`` -> (vals [b, kk], global slots [b, kk])
    on every shard of every lane, then merge each lane's winners on the
    mesh's first device: the shards' columns concatenated in shard order,
    one top-k. A lane is replica row r with its slice of the batch (the
    whole batch on row 0 when ``replica_axis`` is None); ``cache`` holds a
    lane's per-device values (its queries on each device). Returns (vals
    [B, k] f32, slots [B, k] int64)."""
    grid = _grid(mesh, shard_axis)
    home = _home(mesh)
    q = torch.as_tensor(queries).to(torch.float32)
    if replica_axis is None:
        lanes = [(0, q)]
    else:
        if replica_axis not in mesh.axis_names or len(mesh.axis_names) != 2:
            raise ValueError(f"replica axis {replica_axis!r} is not an axis of {mesh.shape}")
        lanes = list(enumerate(torch.tensor_split(q, grid.shape[0])))
    out_v, out_s = [], []
    for r, ql in lanes:
        if ql.shape[0] == 0:
            continue
        cache: Dict = {}
        vals, slots = [], []
        for s in range(grid.shape[1]):
            dev = grid[r, s]
            if ("q", dev) not in cache:
                cache[("q", dev)] = ql.to(dev)
            v, sl = body(r, s, cache[("q", dev)], cache)
            vals.append(v.to(home))
            slots.append(sl.to(home))
        v, sl = take_topk(torch.cat(vals, dim=1), torch.cat(slots, dim=1), k)
        v, sl = _pad_k(v, sl, k)
        out_v.append(v)
        out_s.append(sl)
    if not out_v:
        return (torch.empty((0, k), dtype=torch.float32, device=home),
                torch.empty((0, k), dtype=torch.int64, device=home))
    return torch.cat(out_v), torch.cat(out_s)


# -- flat ----------------------------------------------------------------------------


def _local_topk(q, vecs, norms, valid, k: int, metric: str, chunk: int,
                mode: str = "exact", recall_target: float = 0.99):
    """Top-k over one shard's rows, on the shard's device (q prepared).
    The reference's gate sends a shard of more than 262,144 rows
    (``ops/distance.SEGMAX_MIN_ROWS``) to the segment kernels, k >= 4 to
    B1 and smaller k to B2; otherwise one product and a top-k, or the
    chunked scan past the score-plane budget."""
    from grape_vector_db_tpu_torch.ops.segmax import CB, segmax2_topk, segmax4_topk

    n, d = vecs.shape
    b = q.shape[0]
    kk = min(k, n)
    if (mode == "exact" and k <= distance.SEGMAX_MAX_K and n > distance.SEGMAX_MIN_ROWS
            and metric in ("cosine", "dot") and n % CB == 0 and n // CB <= 65535
            and d % 128 == 0 and b <= distance.SEGMAX_MAX_BATCH):
        eng = segmax4_topk if kk >= 4 else segmax2_topk
        return eng(q, vecs, norms, valid, k=kk, metric=metric)
    if b * n <= distance.MAX_SCORE_ELEMS:
        return torch.topk(score_block(q, vecs, norms, valid, metric), kk, dim=1)
    return chunked_topk(
        lambda lo, hi: score_block(q, vecs[lo:hi], norms[lo:hi], valid[lo:hi], metric),
        n, min(chunk, n), k)


def _flat_topk(queries, vectors, norms, valid, k, metric, chunk, mesh, shard_axis,
               replica_axis, mode):
    vectors = _as_sharded(vectors, mesh, shard_axis, 0)
    norms = _as_sharded(norms, mesh, shard_axis, 0)
    valid = _as_sharded(valid, mesh, shard_axis, 0)
    per_shard = vectors.local

    def body(r, s, q, cache):
        if ("qp", q.device) not in cache:
            cache[("qp", q.device)] = prepare_queries(q, metric)
        vals, idxs = _local_topk(cache[("qp", q.device)], vectors.part(s, r),
                                 norms.part(s, r), valid.part(s, r), k, metric, chunk, mode)
        return vals, idxs + s * per_shard

    return _spmd(queries, mesh, shard_axis, replica_axis, k, body)


def replicated_sharded_topk(
    queries,               # [B, D] f32; split over the replica axis
    vectors,               # [S*C, D] sharded over shard, on every replica row
    norms,
    valid,
    k: int,
    metric: str,
    chunk: int,
    mesh: Mesh,
    shard_axis: str = "shard",
    replica_axis: str = "replica",
    mode: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D query execution: each replica row serves its slice of the batch
    against its own copy of the sharded corpus; one merge a row. Any B
    splits (``torch.tensor_split``). ``recall_target`` is accepted and
    ignored: every selection is exact."""
    return _flat_topk(queries, vectors, norms, valid, k, metric, chunk, mesh, shard_axis,
                      replica_axis, mode)


def sharded_scored_topk(
    queries,               # [B, D] f32, every shard scores all of it
    vectors,               # [S*C, D] sharded on rows over ``shard_axis``
    norms,                 # [S*C]
    valid,                 # [S*C]
    k: int,
    metric: str,
    chunk: int,
    mesh: Mesh,
    shard_axis: str = "shard",
    mode: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k across all shards: each shard's local top-k on its
    device, then one merge. Returns (scores [B, k] f32, global row indices
    [B, k] int64) on the mesh's first device. The operands are
    ``ShardedTensor``s or whole tensors (split)."""
    return _flat_topk(queries, vectors, norms, valid, k, metric, chunk, mesh, shard_axis,
                      None, mode)


class ShardedFlatIndex(VectorIndex):
    """Mesh-sharded exact index: the ``FlatDeviceIndex`` contract, with the
    corpus rows split over the mesh's ``shard`` axis. Slots go round-robin
    over the shards, each with its own free list, so load stays balanced.
    The index's own device is the mesh's first (``device`` only picks the
    host's devices when no mesh is given)."""

    kind = "sharded_flat"
    supports_mask = True

    def __init__(
        self,
        dimension: int,
        mesh: Optional[Mesh] = None,
        metric: str = "cosine",
        storage_dtype: str = "bfloat16",
        shard_capacity: int = 4096,
        shard_axis: str = "shard",
        search_chunk: int = 65536,
        search_mode: str = "exact",
        recall_target: float = 0.99,
        replica_axis: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("cosine", "dot", "euclidean"):
            raise ValueError(f"unknown metric {metric}")
        if storage_dtype not in _STORAGE_DTYPES:
            raise ValueError(f"storage_dtype {storage_dtype!r} is not ported; "
                             f"use one of {sorted(_STORAGE_DTYPES)}")
        self._dim = dimension
        self.metric = metric
        self.search_mode = search_mode
        self.recall_target = recall_target   # accepted, unused: every selection is exact
        self.mesh = mesh if mesh is not None else make_mesh(
            shard_axis=shard_axis, devices=local_devices(device))
        self.shard_axis = shard_axis
        # On a 2-D (replica x shard) mesh the query batch splits over the
        # replica axis; a 1-D mesh gives every shard the whole batch.
        self.replica_axis = replica_axis if replica_axis in self.mesh.axis_names else None
        self.n_replicas = self.mesh.shape[self.replica_axis] if self.replica_axis else 1
        self.n_shards = self.mesh.shape[shard_axis]
        self.shard_capacity = shard_capacity
        self.search_chunk = search_chunk
        self.storage_dtype = _STORAGE_DTYPES[storage_dtype]
        self.device = _home(self.mesh)
        cap = self.n_shards * shard_capacity
        self.capacity = cap
        self.vectors = ShardedTensor.zeros(self.mesh, shard_axis, (cap, dimension),
                                           self.storage_dtype)
        self.norms = ShardedTensor.zeros(self.mesh, shard_axis, (cap,), torch.float32)
        self.valid = ShardedTensor.zeros(self.mesh, shard_axis, (cap,), torch.bool)
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: List[Optional[str]] = [None] * cap
        # Per-shard free lists + next pointers for round-robin placement.
        self._next_in_shard = [0] * self.n_shards
        self._free: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._rr = 0
        # clear() and redistribute() re-run __init__ under the lock, so the
        # lock object must survive it (a new one would let a search in
        # another thread read a half-built state)
        if not hasattr(self, "_lock"):
            self._lock = threading.RLock()

    @property
    def dimension(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._id_to_slot)

    # -- slot assignment --------------------------------------------------------

    def _alloc_slot(self) -> int:
        for _ in range(self.n_shards):
            s = self._rr
            self._rr = (self._rr + 1) % self.n_shards
            if self._free[s]:
                return self._free[s].pop()
            if self._next_in_shard[s] < self.shard_capacity:
                slot = s * self.shard_capacity + self._next_in_shard[s]
                self._next_in_shard[s] += 1
                return slot
        raise MemoryError(
            f"sharded index full ({self.n_shards}x{self.shard_capacity}); "
            "resize via redistribute()")

    # -- mutation -----------------------------------------------------------------

    def add_batch(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, vectors.shape[1])
        if not len(ids):
            return
        last = {i: p for p, i in enumerate(ids)}
        if len(last) != len(ids):
            keep = sorted(last.values())
            ids = [ids[p] for p in keep]
            vectors = vectors[keep]
        with self._lock:
            new = sum(1 for i in ids if i not in self._id_to_slot)
            if len(self._id_to_slot) + new > self.capacity:
                # grow: re-place the corpus at doubled per-shard capacity
                cap = self.shard_capacity
                while self.n_shards * cap < len(self._id_to_slot) + new:
                    cap *= 2
                self.redistribute(self.mesh, shard_capacity=cap)
            slots = np.empty(len(ids), dtype=np.int64)
            for i, id_ in enumerate(ids):
                slot = self._id_to_slot.get(id_)
                if slot is None:
                    slot = self._alloc_slot()
                    self._id_to_slot[id_] = slot
                    self._slot_to_id[slot] = id_
                slots[i] = slot
            for off in range(0, len(ids), _STEP_ROWS):
                # cast on the host: bf16 rows cross at half the bytes
                vecs_d = ship_batch(vectors[off:off + _STEP_ROWS],
                                    self.storage_dtype).to(self.device)
                slots_d = torch.from_numpy(slots[off:off + _STEP_ROWS]).to(self.device)
                self.vectors[slots_d] = vecs_d
                self.norms[slots_d] = _row_norms(vecs_d)
                self.valid[slots_d] = True

    def remove_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            slots = []
            for i in ids:
                s = self._id_to_slot.pop(i, None)
                if s is not None:
                    self._slot_to_id[s] = None
                    self._free[s // self.shard_capacity].append(s)
                    slots.append(s)
            if not slots:
                return 0
            self.valid[torch.as_tensor(slots, dtype=torch.int64)] = False
            return len(slots)

    def _same_layout(self, mesh: Mesh, shard_capacity: int) -> None:
        self.__init__(
            self._dim, mesh=mesh, metric=self.metric,
            storage_dtype=str(self.storage_dtype).removeprefix("torch."),
            shard_capacity=shard_capacity, shard_axis=self.shard_axis,
            search_chunk=self.search_chunk, search_mode=self.search_mode,
            recall_target=self.recall_target, replica_axis=self.replica_axis,
            device=self.device)

    def clear(self) -> None:
        with self._lock:
            self._same_layout(self.mesh, self.shard_capacity)

    # -- search ---------------------------------------------------------------------

    def compile_mask(self, allowed_ids) -> np.ndarray:
        from grape_vector_db_tpu_torch.engine.filtering import mask_from_allowed

        with self._lock:
            return mask_from_allowed(set(allowed_ids), self._slot_to_id, self._id_to_slot)

    def search_batch(self, queries: np.ndarray, k: int,
                     mask: Optional[np.ndarray] = None) -> List[List[SearchHit]]:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        with self._lock:
            if b == 0 or not self._id_to_slot:
                return [[] for _ in range(b)]
            # the padded batch is what the kernel routing reads, as in the
            # reference; a 2-D mesh splits it over its replica lanes
            bb = next_bucket(b, base=8)
            if self.n_replicas > 1:
                bb = -(-bb // self.n_replicas) * self.n_replicas
            chunk = min(self.search_chunk, self.shard_capacity)
            valid = self.valid
            if mask is not None:
                # a slot mask is laid out as the slots are: split it alike
                valid = valid.logical_and(ShardedTensor.from_global(
                    self.mesh, self.shard_axis, np.asarray(mask, dtype=bool)))
            q = torch.from_numpy(pad_rows(queries, bb)).to(self.device)
            if self.replica_axis:
                vals, idxs = replicated_sharded_topk(
                    q, self.vectors, self.norms, valid, k=k, metric=self.metric, chunk=chunk,
                    mesh=self.mesh, shard_axis=self.shard_axis,
                    replica_axis=self.replica_axis, mode=self.search_mode)
            else:
                vals, idxs = sharded_scored_topk(
                    q, self.vectors, self.norms, valid, k=k, metric=self.metric, chunk=chunk,
                    mesh=self.mesh, shard_axis=self.shard_axis, mode=self.search_mode)
            return hits_from_arrays(vals[:b].cpu().numpy(), idxs[:b].cpu().numpy(),
                                    self._slot_to_id)

    # -- resharding ---------------------------------------------------------------

    def redistribute(self, new_mesh: Mesh, shard_capacity: Optional[int] = None) -> None:
        """Re-place the corpus on another mesh (a node joins or leaves): read
        the live rows back and ingest them under the new placement."""
        with self._lock:
            ids, vecs = self.get_all()
            self._same_layout(new_mesh, shard_capacity or self.shard_capacity)
            if ids:
                self.add_batch(ids, vecs)

    # -- introspection ------------------------------------------------------------

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        with self._lock:
            slot = self._id_to_slot.get(id_)
            if slot is None:
                return None
            return self.vectors[torch.tensor([slot])][0].to(torch.float32).cpu().numpy()

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        with self._lock:
            items = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if not items:
                return [], np.zeros((0, self._dim), dtype=np.float32)
            ids = [i for i, _ in items]
            slots = torch.as_tensor([s for _, s in items], dtype=torch.int64)
            vecs = np.empty((len(ids), self._dim), dtype=np.float32)
            for off in range(0, len(ids), _STEP_ROWS):
                vecs[off:off + _STEP_ROWS] = self.vectors[slots[off:off + _STEP_ROWS]].to(
                    torch.float32).cpu().numpy()
            return ids, vecs

    def get_stats(self) -> IndexStats:
        per_shard_live = [0] * self.n_shards
        for s in self._id_to_slot.values():
            per_shard_live[s // self.shard_capacity] += 1
        return IndexStats(
            point_count=len(self._id_to_slot),
            dimension=self._dim,
            capacity=self.capacity,
            kind=self.kind,
            memory_usage_mb=self.capacity * (self.storage_dtype.itemsize * self._dim + 5) / 1e6,
            extra={f"shard_{i}_points": float(c) for i, c in enumerate(per_shard_live)},
        )


# -- IVF: centroids on every device, each list's capacity split over the shards -------


def _probe(cache, q: torch.Tensor, centroids: torch.Tensor, nprobe: int, metric: str):
    """(prepared queries, [B, P] int32 top-nprobe lists) on q's device, once
    a device a lane: every shard of a lane probes the same lists."""
    key = ("probe", q.device)
    if key not in cache:
        qp = prepare_queries(q, metric)
        cents = centroids.to(device=q.device, dtype=torch.float32)
        cq = qp @ cents.T                                             # [B, L]
        if metric == "euclidean":
            c2 = torch.sum(cents * cents, dim=-1)[None, :]
            cq = -(torch.sum(qp * qp, dim=-1, keepdim=True) - 2 * cq + c2)
        _, probe = torch.topk(cq, min(nprobe, cents.shape[0]), dim=1)
        cache[key] = (qp, probe.to(torch.int32))
    return cache[key]


def _on(cache, t: Optional[torch.Tensor], dev: torch.device, name: str):
    """A replicated operand (``nblocks``) on ``dev``, copied once a lane."""
    if t is None:
        return None
    key = (name, dev)
    if key not in cache:
        cache[key] = t.to(dev)
    return cache[key]


def _cell_slots(probe: torch.Tensor, s: int, c_local: int, n_shards: int) -> torch.Tensor:
    """[B, P * C/S] global slots of shard s's columns of the probed lists."""
    b, p = probe.shape
    pos = torch.arange(c_local, device=probe.device)
    return (probe.to(torch.int64)[:, :, None] * (c_local * n_shards) + s * c_local
            + pos[None, None, :]).reshape(b, p * c_local)


def sharded_ivf_topk(
    queries,                 # [B, D] f32 raw
    centroids: torch.Tensor,  # [L, D] f32, the same on every device
    vecs,                    # [L, C, D] sharded over axis 1 (within each list)
    norms,                   # [L, C]    sharded over axis 1
    valid,                   # [L, C]    sharded over axis 1 (validity AND filter)
    k: int,
    nprobe: int,
    metric: str,
    mesh: Mesh,
    shard_axis: str = "shard",
    recip=None,              # [L, C] weight plane, sharded over axis 1
    use_pallas: bool = False,
    interpret: bool = False,
    nblocks: Optional[torch.Tensor] = None,   # [L] occupied RB-row blocks a shard
    replica_axis: Optional[str] = None,       # 2-D mesh: split the batch over rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded IVF probe (the sharded twin of the index's probe): every shard
    scores the same top-nprobe lists over its C/S columns of each, then one
    merge. With ``recip`` and an angular metric each shard runs the probe
    kernel B3 (``ops/ivf.ivf_probe_scores``; its plain version for CPU
    tensors); otherwise the plain gather probe. ``use_pallas`` and
    ``interpret`` (the reference's TPU switches) are accepted and ignored.
    Returns (scores [B, k] f32, slots [B, k] int64) on the mesh's first
    device, slot = list * C + shard * C/S + column."""
    vecs = _as_sharded(vecs, mesh, shard_axis, 1)
    norms = _as_sharded(norms, mesh, shard_axis, 1)
    valid = _as_sharded(valid, mesh, shard_axis, 1)
    recip = _as_sharded(recip, mesh, shard_axis, 1)
    n_shards, c_local = vecs.n_shards, vecs.local
    kernel = recip is not None and metric in ("cosine", "dot")

    def body(r, s, q, cache):
        qp, probe = _probe(cache, q, centroids, nprobe, metric)
        v, msk = vecs.part(s, r), valid.part(s, r)
        b, p = probe.shape
        allowed = msk[probe.to(torch.int64)]                          # [B, P, C/S]
        if kernel:
            scores = ivf_probe_scores(qp, probe, v, recip.part(s, r),
                                      nblocks=_on(cache, nblocks, q.device, "nblocks"))
            if metric == "cosine":
                scores = torch.clamp(scores, max=1.0)
        else:
            pr = probe.to(torch.int64)
            dots = torch.einsum("bd,bpcd->bpc", qp.to(v.dtype).to(torch.float32),
                                v[pr].to(torch.float32))
            cn = norms.part(s, r)[pr]
            if metric == "cosine":
                scores = torch.clamp(dots / torch.clamp(cn, min=1e-12), max=1.0)
            elif metric == "dot":
                scores = dots
            else:
                q_sq = torch.sum(qp * qp, dim=-1)[:, None, None]
                scores = -(q_sq - 2.0 * dots + cn * cn)
        scores = torch.where(allowed, scores, NEG_INF).reshape(b, p * c_local)
        vals, pos = torch.topk(scores, min(k, p * c_local), dim=1)
        return vals, torch.gather(_cell_slots(probe, s, c_local, n_shards), 1, pos)

    return _spmd(queries, mesh, shard_axis, replica_axis, k, body)


def _rescore(qp, probe, scores, v, nrm, live, rescore: int, metric: str, s: int,
             c_local: int, n_shards: int):
    """A shard's exact rescore of its top ``rescore`` code candidates
    against its bf16 rows, before the merge: (exact vals [B, R], slots)."""
    b = scores.shape[0]
    r = min(rescore, scores.shape[1])
    rv, ridx = torch.topk(scores, r, dim=1)
    lists = torch.gather(probe.to(torch.int64), 1, ridx // c_local)     # [B, R]
    pp = ridx % c_local
    cvecs = v[lists, pp].to(torch.float32)                               # [B, R, D]
    cn = nrm[lists, pp]
    d2 = torch.bmm(cvecs, qp.to(v.dtype).to(torch.float32)[:, :, None])[:, :, 0]
    exact = torch.clamp(d2 / torch.clamp(cn, min=1e-12), max=1.0) if metric == "cosine" else d2
    ok = (rv > -1e8) & (cn > 0)
    if live is not None:
        ok &= torch.gather(live.reshape(b, -1), 1, ridx)
    exact = torch.where(ok, exact, NEG_INF)
    return exact, lists * (c_local * n_shards) + s * c_local + pp


def sharded_ivf_int8_topk(
    queries,                 # [B, D] f32 raw
    centroids: torch.Tensor,  # [L, D] f32
    codes,                   # [L, C, D] int8, or [L, C, D/2] packed int4; axis 1 sharded
    scales,                  # [L, C] f32 dequant scales
    norms,                   # [L, C] f32
    valid,                   # [L, C] bool (validity AND filter)
    vecs,                    # [L, C, D] bf16 shadow (rescore > 0) or None
    k: int,
    nprobe: int,
    metric: str,
    rescore: int,
    mesh: Mesh,
    shard_axis: str = "shard",
    factor=None,             # [L, C] weight plane; None: made from scales and norms
    use_pallas: bool = False,
    interpret: bool = False,
    nblocks: Optional[torch.Tensor] = None,
    replica_axis: Optional[str] = None,
    codes_kind: str = "int8",          # "int8" | "int4" (packed nibbles)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded quantized IVF probe, the twin of the int8 / int4 index's:
    every shard scores its C/S columns of the probed lists from the codes
    with B4 (int8) or B5 (int4) (plain versions for CPU tensors); with
    ``rescore > 0`` and a bf16 shadow each shard rescores its own top
    ``rescore`` candidates exactly before the merge, so the merge carries
    exact scores. ``use_pallas`` and ``interpret`` are ignored."""
    codes = _as_sharded(codes, mesh, shard_axis, 1)
    scales = _as_sharded(scales, mesh, shard_axis, 1)
    norms = _as_sharded(norms, mesh, shard_axis, 1)
    valid = _as_sharded(valid, mesh, shard_axis, 1)
    vecs = _as_sharded(vecs, mesh, shard_axis, 1)
    factor = _as_sharded(factor, mesh, shard_axis, 1)
    n_shards, c_local = codes.n_shards, codes.local
    probe_fn = ivf_probe_scores_int4 if codes_kind == "int4" else ivf_probe_scores_int8
    with_v = rescore > 0 and vecs is not None

    def body(r, s, q, cache):
        qp, probe = _probe(cache, q, centroids, nprobe, metric)
        msk, nrm = valid.part(s, r), norms.part(s, r)
        f = (factor.part(s, r) if factor is not None
             else make_factor(scales.part(s, r), nrm, msk, metric))
        b, p = probe.shape
        scores = probe_fn(qp, probe, codes.part(s, r), f,
                          nblocks=_on(cache, nblocks, q.device, "nblocks"))
        if metric == "cosine":
            scores = torch.clamp(scores, max=1.0)
        live = msk[probe.to(torch.int64)]
        flat = torch.where(live, scores, NEG_INF).reshape(b, p * c_local)
        if with_v:
            return _rescore(qp, probe, flat, vecs.part(s, r), nrm, live, rescore, metric, s,
                            c_local, n_shards)
        vals, pos = torch.topk(flat, min(k, p * c_local), dim=1)
        vals = torch.where(vals > -1e8, vals, NEG_INF)
        return vals, torch.gather(_cell_slots(probe, s, c_local, n_shards), 1, pos)

    return _spmd(queries, mesh, shard_axis, replica_axis, k, body)


def _cell_weight(sc, nrm, msk, metric: str, codes_kind: str) -> torch.Tensor:
    """Per-cell score weight, the probes' arithmetic: 1/|v| (cosine) or 1
    for bf16 rows, the dequant scale (over |v| for cosine) for codes;
    0 where not allowed."""
    if codes_kind == "bf16":
        w = 1.0 / torch.clamp(nrm, min=1e-12) if metric == "cosine" else torch.ones_like(nrm)
    elif metric == "cosine":
        w = sc / torch.clamp(nrm, min=1e-12)
    else:
        w = sc
    return torch.where(msk, w, 0.0)


def sharded_ivf_exhaustive_topk(
    queries,                 # [B, D] f32 raw
    data,                    # [L, C, D] bf16|f32|int8 or [L, C, D/2] packed int4; axis 1 sharded
    scales,                  # [L, C] f32 (quantized kinds) or None
    norms,                   # [L, C] f32
    allowed,                 # [L, C] bool = validity AND filter mask
    vecs,                    # [L, C, D] bf16 shadow (rescore) or None
    k: int,
    metric: str,
    mesh: Mesh,
    shard_axis: str = "shard",
    replica_axis: Optional[str] = None,
    codes_kind: str = "bf16",   # "bf16" | "int8" | "int4"
    chunk_lists: int = 8,
    rescore: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded exhaustive masked IVF scan: exact filtered search at any
    selectivity (the twin of ``ops/ivf_scan.ivf_exhaustive_masked_topk``).

    Phase 1: each shard streams its [L, C/S] slice once, ``chunk_lists``
    lists at a time, and reduces each list to its masked score maximum; the
    elementwise max of the shards' [B, L] planes on the first device makes
    it global, so every shard probes the same top ``max(k, 8)`` lists. Phase
    2: each shard scores its columns of those lists with its probe kernel
    (B3 / B4 / B5) and, with ``rescore > 0`` and a bf16 shadow, rescores its
    own winners exactly; one merge. Cosine scores clamp to 1.0 for every
    format, as both single-device tiers do (the reference's sharded twin
    clamps bf16 rows only, ``mesh.py:931``)."""
    data = _as_sharded(data, mesh, shard_axis, 1)
    scales = _as_sharded(scales, mesh, shard_axis, 1)
    norms = _as_sharded(norms, mesh, shard_axis, 1)
    allowed = _as_sharded(allowed, mesh, shard_axis, 1)
    vecs = _as_sharded(vecs, mesh, shard_axis, 1)
    grid = _grid(mesh, shard_axis)
    home = _home(mesh)
    n_shards, c_local = data.n_shards, data.local
    n_lists = data.shape[0]
    with_v = rescore > 0 and vecs is not None
    q = torch.as_tensor(queries).to(torch.float32)
    lanes = ([(0, q)] if replica_axis is None
             else list(enumerate(torch.tensor_split(q, grid.shape[0]))))
    weights: Dict[int, torch.Tensor] = {}

    def weight(r, s):
        key = id(data.part(s, r))
        if key not in weights:
            weights[key] = _cell_weight(None if scales is None else scales.part(s, r),
                                        norms.part(s, r), allowed.part(s, r), metric,
                                        codes_kind)
        return weights[key]

    out_v, out_s = [], []
    for r, ql in lanes:
        if ql.shape[0] == 0:
            continue
        b = ql.shape[0]
        qs: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

        def prepared(dev):
            if dev not in qs:
                qp = prepare_queries(ql.to(dev), metric)
                qs[dev] = (qp, qp.to(torch.bfloat16).to(torch.float32))
            return qs[dev]

        lmax = None
        for s in range(n_shards):
            dev = grid[r, s]
            _, qb = prepared(dev)
            dd, w_all = data.part(s, r), weight(r, s)
            part = torch.empty((b, n_lists), dtype=torch.float32, device=dev)
            for l0 in range(0, n_lists, chunk_lists):
                cand = _dequant(dd[l0:l0 + chunk_lists], codes_kind)
                dots = torch.einsum("bd,lcd->blc", qb, cand)
                w = w_all[l0:l0 + chunk_lists][None]
                part[:, l0:l0 + chunk_lists] = torch.where(w == 0.0, NEG_INF,
                                                           dots * w).amax(dim=2)
            part = part.to(home)
            lmax = part if lmax is None else torch.maximum(lmax, part)
        _, probe = torch.topk(lmax, min(n_lists, max(k, 8)), dim=1)
        probe = probe.to(torch.int32)
        dup = probe_dup_mask(probe)
        vals, slots = [], []
        for s in range(n_shards):
            dev = grid[r, s]
            qp, _ = prepared(dev)
            pr, dp = probe.to(dev), dup.to(dev)
            w_all = weight(r, s)
            scores = _PROBES[codes_kind](qp, pr, data.part(s, r), w_all)
            scores = torch.where((w_all[pr.to(torch.int64)] == 0.0) | dp[:, :, None], NEG_INF,
                                 scores)
            if metric == "cosine":
                scores = torch.clamp(scores, max=1.0)
            p = pr.shape[1]
            flat = scores.reshape(b, p * c_local)
            if with_v:
                v, sl = _rescore(qp, pr, flat, vecs.part(s, r), norms.part(s, r), None,
                                 rescore, metric, s, c_local, n_shards)
            else:
                v, pos = torch.topk(flat, min(k, p * c_local), dim=1)
                sl = torch.gather(_cell_slots(pr, s, c_local, n_shards), 1, pos)
            vals.append(v.to(home))
            slots.append(sl.to(home))
        v, sl = take_topk(torch.cat(vals, dim=1), torch.cat(slots, dim=1), k)
        v, sl = _pad_k(v, sl, k)
        out_v.append(v)
        out_s.append(sl)
    return torch.cat(out_v), torch.cat(out_s)


def _compact_gather(data, scales, norms, cells, metric: str, codes_kind: str, mesh: Mesh,
                    shard_axis: str):
    """Each shard's allowed rows (source dtype), their weights and their
    local cell ids, once a distinct device of the shard:
    {(shard, device): (cells, rows, w)}. ``cells[s]`` holds shard s's local
    flat ids list * C/S + column; -1 pads are dropped here, before any
    index op."""
    grid = _grid(mesh, shard_axis)
    n_lists, c_local = data.shape[0], data.local
    out = {}
    for r in range(grid.shape[0]):
        for s in range(grid.shape[1]):
            dev = grid[r, s]
            if (s, dev) in out:
                continue
            cl = torch.as_tensor(cells[s]).reshape(-1).to(device=dev, dtype=torch.int64)
            cl = cl[cl >= 0]
            if cl.numel() == 0:
                out[s, dev] = None
                continue
            dd = data.part(s, r)
            rows = dd.reshape((n_lists * c_local,) + tuple(dd.shape[2:]))[cl]
            nrm = norms.part(s, r).reshape(-1)[cl]
            sc = None if scales is None else scales.part(s, r).reshape(-1)[cl]
            w = _cell_weight(sc, nrm, torch.ones_like(nrm, dtype=torch.bool), metric,
                             codes_kind)
            out[s, dev] = (cl, rows, w)
    return out


def _compact_scan(queries, gathered, k: int, metric: str, codes_kind: str, mesh: Mesh,
                  shard_axis: str, replica_axis: Optional[str], c_local: int,
                  chunk_rows: int):
    grid = _grid(mesh, shard_axis)
    n_shards = grid.shape[1]

    def body(r, s, q, cache):
        got = gathered[s, grid[r, s]]
        if got is None:
            b = q.shape[0]
            return (torch.full((b, 0), NEG_INF, device=q.device),
                    torch.zeros((b, 0), dtype=torch.int64, device=q.device))
        cl, rows, w = got
        if ("qb", q.device) not in cache:
            cache[("qb", q.device)] = prepare_queries(q, metric).to(torch.bfloat16).to(
                torch.float32)
        vals, idx = compact_scan_core(cache[("qb", q.device)], rows, w, k=k, fmt=codes_kind,
                                      chunk_rows=chunk_rows)
        cellv = cl[idx]
        slots = (cellv // c_local) * (c_local * n_shards) + s * c_local + cellv % c_local
        if metric == "cosine":
            vals = torch.clamp(vals, max=1.0)
        return torch.where(torch.isfinite(vals), vals, NEG_INF), slots

    return _spmd(queries, mesh, shard_axis, replica_axis, k, body)


def sharded_ivf_compact_topk(
    queries,                 # [B, D] f32 raw
    data,                    # [L, C, D] bf16|f32|int8 or [L, C, D/2] int4; axis 1 sharded
    scales,                  # [L, C] f32 (quantized kinds) or None
    norms,                   # [L, C] f32
    cells,                   # per shard: LOCAL flat ids list * C/S + column ([S, R], -1 pads)
    k: int,
    metric: str,
    mesh: Mesh,
    shard_axis: str = "shard",
    replica_axis: Optional[str] = None,
    codes_kind: str = "bf16",
    chunk_rows: int = 131_072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded compact gather-scan, the twin of
    ``ops/ivf_scan.ivf_compact_masked_topk``: each shard gathers its allowed
    rows once and scans just those, then one merge; the cost follows the
    allowed set, not the corpus. ``cells`` is one id list a shard (ragged),
    or the reference's ``[S, R]`` bucket with -1 pads, which are dropped.
    The cells are the caller's: a cell whose row was deleted scores as its
    stored row does, so build them from the allowed AND valid cells."""
    data = _as_sharded(data, mesh, shard_axis, 1)
    scales = _as_sharded(scales, mesh, shard_axis, 1)
    norms = _as_sharded(norms, mesh, shard_axis, 1)
    gathered = _compact_gather(data, scales, norms, cells, metric, codes_kind, mesh,
                               shard_axis)
    return _compact_scan(queries, gathered, k, metric, codes_kind, mesh, shard_axis,
                         replica_axis, data.local, chunk_rows)


class ShardedIvfIndex(IvfDeviceIndex):
    """Mesh-sharded IVF: the ``IvfDeviceIndex`` contract and host
    bookkeeping, with every list's capacity split over the mesh's ``shard``
    axis (each plane a ``ShardedTensor`` along axis 1) and search run on
    every shard with one merge. Rows stripe over the shards
    (``_phys_pos``), so every shard's slice of a list fills alike. The
    overflow region and the centroids live on the mesh's first device."""

    kind = "sharded_ivf"
    supports_mask = True
    supports_exhaustive_mask = True

    def __init__(
        self,
        dimension: int,
        mesh: Optional[Mesh] = None,
        shard_axis: str = "shard",
        replica_axis: Optional[str] = None,
        **kwargs,
    ):
        device = kwargs.pop("device", "cuda")
        self.mesh = mesh if mesh is not None else make_mesh(
            shard_axis=shard_axis, devices=local_devices(device))
        self.shard_axis = shard_axis
        self.replica_axis = replica_axis if replica_axis in self.mesh.axis_names else None
        self.n_replicas = self.mesh.shape[self.replica_axis] if self.replica_axis else 1
        self.n_shards = self.mesh.shape[shard_axis]
        super().__init__(dimension, device=_home(self.mesh), **kwargs)

    # -- layout -------------------------------------------------------------------

    def _shard_cap(self, cap: int) -> int:
        """List capacity rounded to a multiple of the shard count, so every
        shard holds as many columns. The port's probe kernels need no wider
        unit (the reference's TPU kernel needed 128-lane slices)."""
        unit = self.n_shards
        return -(-cap // unit) * unit

    def _alloc(self, cap: int) -> None:
        self.list_cap = self._shard_cap(cap)
        super()._alloc(self.list_cap)

    def _zeros(self, shape, dtype: torch.dtype) -> ShardedTensor:
        return ShardedTensor.zeros(self.mesh, self.shard_axis, shape, dtype, axis=1)

    def _phys_pos(self, n: int) -> int:
        """Stripe the insert order over the shards: row n of a list lands on
        shard n % S at column n // S, so every shard's watermark is ceil(n/S)
        and the probe skips the same padding on each."""
        s = self.n_shards
        return (n % s) * (self.list_cap // s) + n // s

    def _nblocks(self) -> torch.Tensor:
        """Occupied 64-row blocks of each list on each shard (the same on
        all of them, striped): ceil(ceil(next_pos / S) / 64)."""
        if self._nblocks_cache is None:
            self._nblocks_cache = nblocks_from_counts(-(-self._next_pos // self.n_shards),
                                                      device=self.device)
        return self._nblocks_cache

    def _plane_names(self) -> Tuple[str, ...]:
        return ("vecs", "norms", "valid", "recip")

    def load_state(self, **state) -> None:
        """``IvfDeviceIndex.load_state`` (a JAX index's state, read back with
        ``np.asarray``), then every plane split over the mesh."""
        if int(state["list_cap"]) % self.n_shards:
            raise ValueError(f"list_cap {state['list_cap']} does not split over "
                             f"{self.n_shards} shards")
        super().load_state(**state)
        with self._lock:
            for name in self._plane_names():
                t = getattr(self, name, None)
                if isinstance(t, torch.Tensor):
                    setattr(self, name, ShardedTensor.from_global(
                        self.mesh, self.shard_axis, t, axis=1))

    def _shard_mask(self, cell_mask) -> ShardedTensor:
        return ShardedTensor.from_global(self.mesh, self.shard_axis,
                                         np.asarray(cell_mask, dtype=bool), axis=1)

    def _allowed(self, mask) -> ShardedTensor:
        return self.valid if mask is None else self.valid.logical_and(
            self._shard_mask(mask[0]))

    # -- search -------------------------------------------------------------------

    def _main_topk(self, qp: torch.Tensor, k: int, mask, nprobe=None):
        angular = self.metric in ("cosine", "dot")
        return sharded_ivf_topk(
            qp, self.centroids, self.vecs, self.norms, self._allowed(mask), k=k,
            nprobe=min(nprobe or self.nprobe, self.nlist), metric=self.metric,
            mesh=self.mesh, shard_axis=self.shard_axis,
            recip=self.recip if angular else None,
            nblocks=self._nblocks() if angular else None, replica_axis=self.replica_axis)

    def _sharded_scan_operands(self, k: int):
        """(data, scales, format, rescore rows, rescore count) for the
        exhaustive tiers (subclass seam: the quantized layouts swap in their
        codes and the exact rescore)."""
        return self.vecs, None, "bf16", None, 0

    def _exhaustive_topk(self, qp: torch.Tensor, k: int, mask):
        """Exact masked top-k over every list, as the single-device tiers
        route it: the compact gather-scan of each shard's allowed rows when
        each shard's share fits ``compact_max_bytes``, else the streaming
        scan. The allowed cells are the mask AND validity: a mask compiled
        before a delete must not bring the deleted row back (the reference's
        sharded compact tier skips validity, ``mesh.py:1247-1273``)."""
        data, scales, fmt, vecs, rescore = self._sharded_scan_operands(k)
        s, cl = self.n_shards, self.list_cap // self.n_shards
        m = np.asarray(mask[0], dtype=bool) & np.asarray(self.valid)
        m3 = m.reshape(self.nlist, s, cl)
        r_max = int(m3.sum(axis=(0, 2)).max())
        cdata, cscales, ckind = data, scales, fmt
        if vecs is not None:
            # a quantized kind keeping a bf16 shadow gathers full-precision
            # rows: the compact tier's scores are exact, not quantized
            cdata, cscales, ckind = vecs, None, "bf16"
        row_bytes = int(np.prod(cdata.shape[2:])) * torch.empty(
            (), dtype=cdata.dtype).element_size()
        if r_max > 0 and r_max * row_bytes <= self.compact_max_bytes:
            cells = [np.flatnonzero(m3[:, si, :].reshape(-1)) for si in range(s)]
            # Keyed by the cells' bytes (never by a hash of them) and the
            # write epoch: any write, delete, optimize or clear invalidates.
            key = (self._mutation_epoch, ckind, tuple(c.tobytes() for c in cells))
            cached = self._compact_cache
            if cached is not None and cached[0] == key:
                gathered = cached[1]
            else:
                self._compact_cache = None   # free the old rows before the gather
                gathered = _compact_gather(cdata, cscales, self.norms, cells, self.metric,
                                           ckind, self.mesh, self.shard_axis)
                self._compact_cache = (key, gathered)
            return _compact_scan(qp, gathered, k, self.metric, ckind, self.mesh,
                                 self.shard_axis, self.replica_axis, cl,
                                 min(131_072, r_max))
        return sharded_ivf_exhaustive_topk(
            qp, data, scales, self.norms, self._allowed(mask), vecs, k=k, metric=self.metric,
            mesh=self.mesh, shard_axis=self.shard_axis, replica_axis=self.replica_axis,
            codes_kind=fmt, chunk_lists=default_chunk_lists(self.nlist, cl), rescore=rescore)


class ShardedInt8IvfIndex(ShardedIvfIndex, Int8IvfDeviceIndex):
    """Mesh-sharded int8 IVF: ``ShardedIvfIndex``'s split lists over
    ``Int8IvfDeviceIndex``'s int8 codes and factor plane. Each shard probes
    its columns with B4; with ``keep_bf16`` each shard rescores its own
    winners exactly before the merge."""

    kind = "sharded_ivf_int8"
    supports_mask = True
    codes_kind = "int8"

    def _plane_names(self) -> Tuple[str, ...]:
        return super()._plane_names() + ("codes", "scales", "factor")

    def _sharded_scan_operands(self, k: int):
        r = self._rescore_count(k)
        return self.codes, self.scales, self.codes_kind, self.vecs if r else None, r

    def _main_topk(self, qp: torch.Tensor, k: int, mask, nprobe=None):
        r = self._rescore_count(k)
        return sharded_ivf_int8_topk(
            qp, self.centroids, self.codes, self.scales, self.norms, self._allowed(mask),
            self.vecs if r else None, k=k, nprobe=min(nprobe or self.nprobe, self.nlist),
            metric=self.metric, rescore=r, mesh=self.mesh, shard_axis=self.shard_axis,
            factor=self.factor, nblocks=self._nblocks(), replica_axis=self.replica_axis,
            codes_kind=self.codes_kind)


class ShardedInt4IvfIndex(ShardedInt8IvfIndex, Int4IvfDeviceIndex):
    """Mesh-sharded packed-int4 IVF: ``ShardedInt8IvfIndex`` over
    ``Int4IvfDeviceIndex``'s split-plane nibbles; each shard probes with B5."""

    kind = "sharded_ivf_int4"
    codes_kind = "int4"

"""ProjectedInt8IvfIndex / ProjectedInt4IvfIndex — PCA-projected int8/int4 IVF.

PyTorch counterpart of ``grape_vector_db_tpu/index/ivf_proj.py``: rows are
projected onto the corpus's top-R principal directions (uncentred PCA, so dot
products and cosine ranking survive on the retained subspace) and the whole
int8 or int4 IVF engine runs at R lanes (``proj_dim``, 384 by default):
spherical k-means, the probe kernels B4/B5 (``csrc/ivf_probe.cu`` at
D = R), quantization, masked search. Queries pay one [D, R] product. The
external ``VectorIndex`` contract speaks full-dim vectors; ``get_vector`` /
``get_all`` back-project.

The projection fits on the first batch (or ``train()``); ``optimize()``
refits it with the centroids on the whole corpus. A retained-energy fraction
below ``ENERGY_WARN`` warns; below ``min_energy`` the fit refuses.

``ShardedProjectedInt8IvfIndex`` / ``ShardedProjectedInt4IvfIndex`` put the
projection over the mesh-sharded int8 / int4 lists (``parallel/mesh.py``):
each shard holds 1/S of every list's R-dim codes and probes them with B4 /
B5 at D = R. They are built on first access (the module ``__getattr__``).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.index.ivf import _from_numpy
from grape_vector_db_tpu_torch.index.ivf_int4 import Int4IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int8 import Int8IvfDeviceIndex
from grape_vector_db_tpu_torch.ops.kmeans import assign_clusters
from grape_vector_db_tpu_torch.utils.buckets import next_bucket

__all__ = ["ProjectedInt8IvfIndex", "ProjectedInt4IvfIndex",
           "ShardedProjectedInt8IvfIndex", "ShardedProjectedInt4IvfIndex"]


def _fit_projection(sample: torch.Tensor, r: int) -> Tuple[torch.Tensor, float]:
    """Top-r eigenvectors of the uncentred second moment E[xx^T] ([D, r] f32,
    largest first) and the retained-energy fraction (the top-r eigenvalues
    over their total). Each eigenvector is defined up to its sign."""
    x = sample.to(torch.float32)
    cov = x.T @ x
    evals, evecs = torch.linalg.eigh(cov)        # ascending eigenvalues
    evals = torch.clamp(evals, min=0.0)          # clip fp noise on near-zeros
    energy = evals[-r:].sum() / torch.clamp(evals.sum(), min=1e-30)
    return evecs.flip(1)[:, :r].contiguous(), float(energy)


class ProjectedInt8IvfIndex(Int8IvfDeviceIndex):
    kind = "ivf_int8_proj"

    # Below this retained-energy fraction the projection loses recall that
    # no rescore recovers (the reference measured 0.69-0.81 end to end at
    # energy 0.82 on text-like embeddings); warn and point at full-dim int4.
    ENERGY_WARN = 0.9

    def __init__(self, dimension: int, proj_dim: int = 384, min_energy: float = 0.0,
                 **kwargs):
        if proj_dim >= dimension:
            raise ValueError(f"proj_dim {proj_dim} must be < dimension {dimension}")
        if proj_dim % 128:
            raise ValueError(f"proj_dim {proj_dim} must be a multiple of 128 "
                             "(the reference's alignment rule, kept for parity)")
        self.full_dim = dimension
        self.proj_dim = proj_dim
        self.min_energy = min_energy                   # refuse-to-build floor
        self.proj_energy: Optional[float] = None       # retained energy at fit
        self.proj: Optional[torch.Tensor] = None       # [D, R] f32
        super().__init__(proj_dim, **kwargs)           # the engine runs at R

    @property
    def dimension(self) -> int:
        return self.full_dim

    # -- projection -------------------------------------------------------------

    def _project(self, vectors: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32)).to(self.device)
        return (x @ self.proj).cpu().numpy()

    def _maybe_fit(self, sample: np.ndarray) -> None:
        if self.proj is not None:
            return
        proj, energy = _fit_projection(
            torch.from_numpy(np.ascontiguousarray(sample, dtype=np.float32)).to(self.device),
            self.proj_dim)
        if energy < self.min_energy:
            raise ValueError(
                f"{self.kind}: sample retains only {energy:.3f} of spectral energy at "
                f"proj_dim={self.proj_dim} (< min_energy={self.min_energy}); use full-dim "
                f"kind='ivf_int4' at equal bytes/row, or raise proj_dim")
        if energy < self.ENERGY_WARN:
            warnings.warn(
                f"{self.kind}: flat-spectrum corpus: the {self.proj_dim}-d projection "
                f"retains only {energy:.3f} of spectral energy (< {self.ENERGY_WARN}); "
                f"expect recall loss no rescore recovers. Prefer full-dim "
                f"kind='ivf_int4' at equal bytes/row, or raise proj_dim.",
                RuntimeWarning, stacklevel=3)
        self.proj = proj
        self.proj_energy = energy

    # -- training / mutation ------------------------------------------------------

    def train(self, sample: np.ndarray, seed: int = 0) -> None:
        sample = np.asarray(sample, dtype=np.float32)
        if sample.shape[1] == self._dim and self.proj is not None:
            # already-projected rows (the parent's auto-train pools the
            # overflow region, which holds projected vectors)
            super().train(sample, seed=seed)
            return
        if sample.shape[1] != self.full_dim:
            raise DimensionMismatchError(self.full_dim, sample.shape[1])
        self._maybe_fit(sample)
        super().train(self._project(sample), seed=seed)

    def add_batch(self, ids, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.full_dim:
            raise DimensionMismatchError(self.full_dim,
                                         vectors.shape[1] if vectors.ndim == 2 else -1)
        # the projection fits on the first batch (refit via optimize())
        self._maybe_fit(vectors)
        super().add_batch(ids, self._project(vectors))

    def _place(self, ids, vectors: np.ndarray) -> None:
        # optimize() re-places full-dim rows from get_all(); project them
        if vectors.shape[1] == self.full_dim:
            vectors = self._project(vectors)
        super()._place(ids, vectors)

    def clear(self) -> None:
        super().clear()
        self.proj = None
        self.proj_energy = None

    def load_state(self, *, proj, proj_energy: Optional[float] = None, **state) -> None:
        """The parent's ``load_state`` plus the [D, R] projection."""
        proj = np.asarray(proj)
        if proj.shape != (self.full_dim, self.proj_dim):
            raise ValueError(f"proj must be [{self.full_dim}, {self.proj_dim}]")
        super().load_state(**state)
        with self._lock:
            self.proj = _from_numpy(proj, torch.float32, self.device)
            self.proj_energy = None if proj_energy is None else float(proj_energy)

    def optimize(self) -> None:
        """Refit the projection and the centroids on the whole corpus and
        repack (the parent's optimize would size lists with full-dim rows
        against R-dim centroids)."""
        with self._lock:
            ids, vecs = self.get_all()          # full-dim (back-projected)
            if len(ids) < self.nlist:
                return
            self.clear()
            self.train(vecs)                    # refits projection + centroids
            pv = self._project(vecs)
            counts = np.bincount(
                assign_clusters(torch.from_numpy(pv).to(self.device), self.centroids,
                                mode=self._kmeans_mode).cpu().numpy(),
                minlength=self.nlist)
            need = int(counts.max())
            if need > self.list_cap:
                self.list_cap = next_bucket(int(need * 1.25) + 1, base=128)
                self._alloc_lists(self.list_cap)
            self._place(ids, pv)

    # -- search -------------------------------------------------------------------

    def search_batch(self, queries: np.ndarray, k: int, mask=None, nprobe=None,
                     exhaustive: bool = False) -> List[List]:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.full_dim:
            raise DimensionMismatchError(self.full_dim,
                                         queries.shape[1] if queries.ndim == 2 else -1)
        if self.proj is None:
            return super().search_batch(queries[:, :self._dim], k, mask=mask,
                                        nprobe=nprobe, exhaustive=exhaustive)
        return super().search_batch(self._project(queries), k, mask=mask, nprobe=nprobe,
                                    exhaustive=exhaustive)

    # -- introspection (back-project to the caller's space) -----------------------

    def _back(self, rows_r: np.ndarray) -> np.ndarray:
        if self.proj is None:
            out = np.zeros((rows_r.shape[0], self.full_dim), np.float32)
            out[:, :rows_r.shape[1]] = rows_r
            return out
        return (torch.from_numpy(rows_r).to(self.device) @ self.proj.T).cpu().numpy()

    def get_vector(self, id_: str) -> Optional[np.ndarray]:
        v = super().get_vector(id_)
        if v is None:
            return None
        return self._back(v[None, :])[0]

    def get_all(self) -> Tuple[List[str], np.ndarray]:
        ids, rows = super().get_all()
        if not ids:
            return ids, np.zeros((0, self.full_dim), np.float32)
        return ids, self._back(rows)

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        stats.dimension = self.full_dim
        stats.extra["proj_dim"] = float(self.proj_dim)
        if self.proj_energy is not None:
            stats.extra["proj_energy"] = round(self.proj_energy, 4)
        return stats


class ProjectedInt4IvfIndex(ProjectedInt8IvfIndex, Int4IvfDeviceIndex):
    """PCA projection over packed-int4 lists (R/2 bytes of codes a row). The
    MRO routes the projection wrapper's super() calls into
    ``Int4IvfDeviceIndex``, so the int4 probe (B5) runs unchanged at R lanes;
    R = 384 gives 192 packed bytes a row, twelve 16-byte chunks."""

    kind = "ivf_int4_proj"


def _make_sharded_projected():
    """The two sharded classes, built when first asked for: the parallel
    package imports this module's parents, so it is imported here late."""
    from grape_vector_db_tpu_torch.parallel.mesh import (ShardedInt4IvfIndex,
                                                         ShardedInt8IvfIndex)

    class ShardedProjectedInt8IvfIndex(ProjectedInt8IvfIndex, ShardedInt8IvfIndex):
        """The projection over the mesh-sharded int8 lists: S shards hold S x
        the single-device row count at its recall. MRO: the projection
        wrappers over the sharded layout over the int8 planes."""

        kind = "sharded_ivf_int8_proj"

    class ShardedProjectedInt4IvfIndex(ProjectedInt8IvfIndex, ShardedInt4IvfIndex):
        """The projection over the mesh-sharded packed-int4 lists."""

        kind = "sharded_ivf_int4_proj"

    return ShardedProjectedInt8IvfIndex, ShardedProjectedInt4IvfIndex


def __getattr__(name):
    # the sharded classes resolve on first access (PEP 562)
    if name in ("ShardedProjectedInt8IvfIndex", "ShardedProjectedInt4IvfIndex"):
        i8, i4 = _make_sharded_projected()
        globals()["ShardedProjectedInt8IvfIndex"] = i8
        globals()["ShardedProjectedInt4IvfIndex"] = i4
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_sharded_projected_cls(codes_kind: str = "int8"):
    name = ("ShardedProjectedInt4IvfIndex" if codes_kind == "int4"
            else "ShardedProjectedInt8IvfIndex")
    cls = globals().get(name)
    return cls if cls is not None else __getattr__(name)

"""IvfPqDeviceIndex — IVF partitioning + PQ codes + a configurable rescore.

PyTorch counterpart of ``grape_vector_db_tpu/index/ivf_pq.py``: stage 1
probes the top-nprobe k-means lists, stage 2 scores the probed cells with
ADC lookups over uint8 PQ codes (``ops/pq.py``), stage 3 rescores the best
candidates against a resident plane. Knobs:

- ``residual`` (default True): encode x - centroid(list) instead of x; the
  centroid dot stage 1 already computed is added back at scan time.
- ``resident``: the plane behind the rescore. ``"bf16"``: full-precision
  lists (the parent's); ``"int8"``: int8 lists, half the bytes; ``"none"``:
  codes only, the ranking is pure ADC, and ``get_vector`` / ``get_all``
  decode rows from the codes.

Search is ``IvfDeviceIndex.search_batch`` with the ADC scan in its
``_main_topk`` seam. Until the codebooks are trained, that is the parent's
exact IVF probe (the ``bf16`` config) or the overflow region's exact scan.
The trained path has no kernel of its own (the reference's is an XLA
gather), and the exhaustive filter tiers do not apply
(``supports_exhaustive_mask`` False).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grape_vector_db_tpu_torch.index.ivf import IvfDeviceIndex, _from_numpy
from grape_vector_db_tpu_torch.ops.distance import prepare_queries
from grape_vector_db_tpu_torch.ops.int8 import quantize_int8
from grape_vector_db_tpu_torch.ops.ivf import _pad_k
from grape_vector_db_tpu_torch.ops.kmeans import assign_clusters
from grape_vector_db_tpu_torch.ops.pq import encode_pq, train_pq
from grape_vector_db_tpu_torch.utils.buckets import next_bucket

__all__ = ["IvfPqDeviceIndex"]

NEG_INF = float("-inf")


def _ivfpq_topk(
    queries: torch.Tensor,     # [B, D] f32
    centroids: torch.Tensor,   # [L, D] f32
    codebooks: torch.Tensor,   # [S, 256, dsub] f32
    codes: torch.Tensor,       # [L, C, S] uint8
    rvecs: Optional[torch.Tensor],    # rescore plane [L, C, D] bf16 / f32 / int8, or None
    rscales: Optional[torch.Tensor],  # [L, C] f32 int8 dequant scales (int8 plane only)
    norms: torch.Tensor,       # [L, C] f32
    valid: torch.Tensor,       # [L, C] bool
    nprobe: int,
    rescore_k: int,
    k: int,
    metric: str,
    residual: bool,
):
    """(vals [B, k] f32, slots [B, k] int64; slot = list * C + pos) of the
    three-stage IVF-PQ search (the reference's ``_ivfpq_topk``)."""
    b, d = queries.shape
    l, c, s = codes.shape
    q = prepare_queries(queries, metric)

    # stage 1: probe lists
    cq = q @ centroids.T
    if metric == "euclidean":
        c2 = torch.sum(centroids * centroids, dim=-1)[None, :]
        cq_aff = -(torch.sum(q * q, dim=-1, keepdim=True) - 2 * cq + c2)
    else:
        cq_aff = cq
    _, probe = torch.topk(cq_aff, min(nprobe, l), dim=1)            # [B, P]
    p = probe.shape[1]

    # stage 2: ADC over the probed cells, summed over the subspaces in order
    dsub = codebooks.shape[2]
    lut = torch.einsum("bsd,skd->bsk", q.reshape(b, s, dsub), codebooks)   # [B, S, 256]
    cand_codes = codes[probe].reshape(b, p * c, s)                  # [B, P*C, S] uint8
    cand_norms = norms[probe].reshape(b, p * c)
    cand_valid = valid[probe].reshape(b, p * c)
    dots = torch.zeros((b, p * c), dtype=torch.float32, device=q.device)
    for si in range(s):
        dots = dots + torch.gather(lut[:, si, :], 1, cand_codes[:, :, si].to(torch.int64))
    if residual:
        # q.x = q.centroid_l + q.residual: the centroid term is stage 1's
        cqp = torch.gather(cq, 1, probe)                             # [B, P]
        dots = dots + torch.repeat_interleave(cqp, c, dim=1)
    if metric == "cosine":
        qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        scores = dots / torch.clamp(cand_norms * qn, min=1e-12)
    elif metric == "dot":
        scores = dots
    else:
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        scores = -(q_sq - 2.0 * dots + cand_norms * cand_norms)
    scores = torch.where(cand_valid, scores, NEG_INF)
    pos_in_cell = torch.arange(c, device=q.device)
    gslot = (probe[:, :, None] * c + pos_in_cell[None, None, :]).reshape(b, p * c)

    if rescore_k <= 0 or rvecs is None:
        # codes-only config: the ranking is the ADC scores
        fvals, fpos = torch.topk(scores, min(k, p * c), dim=1)
        return _pad_k(fvals, torch.gather(gslot, 1, fpos), k)

    rk = min(rescore_k, p * c)
    avals, apos = torch.topk(scores, rk, dim=1)
    cand_slot = torch.gather(gslot, 1, apos)                         # [B, rk]

    # stage 3: rescore the rk winners against the resident plane
    lst, pos = cand_slot // c, cand_slot % c
    rrows = rvecs[lst, pos].to(torch.float32)                        # [B, rk, D]
    rnorms = norms[lst, pos]
    qdt = torch.bfloat16 if rvecs.dtype == torch.int8 else rvecs.dtype
    qc = q.to(qdt).to(torch.float32)
    rdots = torch.bmm(rrows, qc[:, :, None])[:, :, 0]
    if rvecs.dtype == torch.int8:
        rdots = rdots * rscales[lst, pos]
    if metric == "cosine":
        rscores = torch.clamp(rdots / torch.clamp(rnorms, min=1e-12), max=1.0)
    elif metric == "dot":
        rscores = rdots
    else:
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        rscores = -(q_sq - 2.0 * rdots + rnorms * rnorms)
    rscores = torch.where(torch.isfinite(avals), rscores, NEG_INF)
    fvals, fpos = torch.topk(rscores, min(k, rk), dim=1)
    return _pad_k(fvals, torch.gather(cand_slot, 1, fpos), k)


class IvfPqDeviceIndex(IvfDeviceIndex):
    kind = "ivf_pq"
    # PQ codes need the ADC arithmetic, not the shared bf16/int8/int4 scan.
    supports_exhaustive_mask = False

    def __init__(self, *args, n_sub: Optional[int] = None, nbits: int = 8,
                 rescore_k: int = 256, residual: bool = True, resident: str = "bf16",
                 **kwargs):
        if resident not in ("bf16", "int8", "none"):
            raise ValueError(f"resident must be bf16|int8|none, got {resident}")
        self.nbits = nbits
        self.rescore_k = rescore_k
        self.residual = bool(residual)
        self.resident = resident
        self.codebooks: Optional[torch.Tensor] = None   # [S, 2^nbits, dsub] f32
        super().__init__(*args, **kwargs)
        self.n_sub = n_sub if n_sub is not None else max(1, self._dim // 8)
        if self._dim % self.n_sub:
            raise ValueError(f"dim {self._dim} not divisible by n_sub {self.n_sub}")
        self.codes = torch.zeros((self.nlist, self.list_cap, self.n_sub), dtype=torch.uint8,
                                 device=self.device)

    # -- storage seams ----------------------------------------------------------

    def _auto_train_threshold(self) -> int:
        # codebooks need 2^nbits rows; until then inserts stay in the exact
        # overflow region (the codes-resident configs have no bf16 probe)
        return max(self.nlist * 4, 2 ** self.nbits)

    def optimize(self) -> None:
        # Guard before the parent's clear(): a codes-resident retrain with
        # too few rows would otherwise raise with the index already wiped.
        if self.resident != "bf16" and len(self) < 2 ** self.nbits:
            return
        super().optimize()

    def _alloc(self, cap: int) -> None:
        l, d, dev = self.nlist, self._dim, self.device
        if self.resident == "bf16":
            super()._alloc(cap)
            self.codes8 = self.scales8 = None
        else:
            self.vecs = None
            self.norms = torch.zeros((l, cap), dtype=torch.float32, device=dev)
            self.valid = torch.zeros((l, cap), dtype=torch.bool, device=dev)
            self.recip = None
            if self.resident == "int8":
                self.codes8 = torch.zeros((l, cap, d), dtype=torch.int8, device=dev)
                self.scales8 = torch.zeros((l, cap), dtype=torch.float32, device=dev)
            else:
                self.codes8 = self.scales8 = None
        if getattr(self, "n_sub", None):
            self.codes = torch.zeros((l, cap, self.n_sub), dtype=torch.uint8, device=dev)

    def _scatter_rows(self, lists, pos, vecs, norms) -> None:
        if self.resident == "bf16":
            super()._scatter_rows(lists, pos, vecs, norms)
            return
        self.norms[lists, pos] = norms
        self.valid[lists, pos] = True
        if self.resident == "int8":
            codes, scales = quantize_int8(vecs)
            self.codes8[lists, pos] = codes
            self.scales8[lists, pos] = scales

    def train(self, sample: np.ndarray, seed: int = 0) -> None:
        sample = np.asarray(sample, dtype=np.float32)
        # validate before any state changes: a codes-resident index with
        # centroids but no codebooks has no plane to search
        if sample.shape[0] < 2 ** self.nbits and self.resident != "bf16":
            raise ValueError(f"{2 ** self.nbits} training vectors required for "
                             f"{self.nbits}-bit PQ (resident={self.resident})")
        super().train(sample, seed=seed)
        if sample.shape[0] < 2 ** self.nbits:
            # bf16 config: too few rows for 2^nbits codewords; stay on the
            # exact IVF probe until optimize() retrains on a larger corpus
            self.codebooks = None
            return
        if sample.shape[0] > 65536:
            sel = np.random.default_rng(seed).choice(sample.shape[0], 65536, replace=False)
            sample = sample[sel]
        enc_in = torch.from_numpy(sample).to(self.device)
        if self.residual:
            # the codebooks model the residual distribution
            assign = assign_clusters(enc_in, self.centroids, mode=self._kmeans_mode)
            enc_in = enc_in - self.centroids[assign.to(torch.int64)]
        self.codebooks = train_pq(enc_in, n_sub=self.n_sub, nbits=self.nbits, seed=seed)

    def _post_scatter(self, lists, pos, vecs) -> None:
        if self.codebooks is None:
            return
        x = vecs.to(torch.float32)
        if self.residual:
            x = x - self.centroids[lists]
        self.codes[lists, pos] = encode_pq(x, self.codebooks)

    def load_state(self, *, codes, codebooks=None, codes8=None, scales8=None,
                   **state) -> None:
        """``IvfDeviceIndex.load_state`` plus the PQ planes: ``codes``
        [L, C, S] uint8, the trained ``codebooks`` (None: untrained) and,
        for ``resident="int8"``, ``codes8`` [L, C, D] and ``scales8`` [L, C]."""
        super().load_state(**state)
        dev = self.device
        with self._lock:
            self.codes = _from_numpy(codes, torch.uint8, dev)
            self.codebooks = None if codebooks is None else _from_numpy(
                codebooks, torch.float32, dev)
            if self.resident == "int8":
                self.codes8 = _from_numpy(codes8, torch.int8, dev)
                self.scales8 = _from_numpy(scales8, torch.float32, dev)

    # -- host reads (codes-resident configs reconstruct) --------------------------

    def _rows_at(self, lists, pos) -> torch.Tensor:
        if self.resident == "bf16":
            return super()._rows_at(lists, pos)
        if self.resident == "int8":
            return self.codes8[lists, pos].to(torch.float32) * self.scales8[lists, pos][:, None]
        code = self.codes[lists, pos].to(torch.int64)                # [n, S]
        s = code.shape[1]
        dec = self.codebooks[torch.arange(s, device=code.device)[None, :], code]
        dec = dec.reshape(code.shape[0], self._dim)
        if self.residual:
            dec = dec + self.centroids[lists]
        return dec.to(torch.float32)

    # -- search -----------------------------------------------------------------

    def _main_topk(self, qp: torch.Tensor, k: int, mask, nprobe=None):
        if self.codebooks is None:
            return super()._main_topk(qp, k, mask, nprobe=nprobe)   # exact until trained
        if self.resident == "none":
            rk, rvecs, rscales = 0, None, None
        else:
            rk = next_bucket(max(self.rescore_k, k), base=64)
            rvecs = self.vecs if self.resident == "bf16" else self.codes8
            rscales = self.scales8
        # the filter mask ANDs into cell validity before the ADC scan, so
        # the code prescan and the rescore see only allowed rows
        valid = self.valid if mask is None else self.valid & self._mask_tensor(mask)
        return _ivfpq_topk(
            qp, self.centroids, self.codebooks, self.codes, rvecs, rscales, self.norms, valid,
            nprobe=min(nprobe or self.nprobe, self.nlist), rescore_k=rk, k=k,
            metric=self.metric, residual=self.residual)

    def get_stats(self):
        stats = super().get_stats()
        stats.kind = self.kind
        per_row = self.n_sub + 4 + 1  # PQ codes + norm + valid
        if self.resident == "bf16":
            per_row += self.storage_dtype.itemsize * self._dim
        elif self.resident == "int8":
            per_row += self._dim + 4
        stats.memory_usage_mb = self.nlist * self.list_cap * per_row / 1e6
        stats.extra["n_sub"] = float(self.n_sub)
        stats.extra["rescore_k"] = float(self.rescore_k)
        stats.extra["residual"] = float(self.residual)
        return stats

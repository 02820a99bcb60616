"""Exact masked IVF search at any selectivity: the exhaustive device tiers.

PyTorch counterpart of ``grape_vector_db_tpu/ops/ivf_scan.py``. The probe
visits ``nprobe`` lists, so a filter mask folded into it is exact only over
those lists. The planner sends low-selectivity filters on the IVF family here
(``QueryConfig.filter_exhaustive_below``); two tiers give the exact masked
top-k:

- **streaming** (``ivf_exhaustive_masked_topk``): phase 1 reads every list
  once, in chunks of lists, and reduces each list to its masked score
  maximum, a [B, L] plane (plain torch: a chunked f32 einsum and a max, as
  the reference leaves it to XLA). Phase 2 probes each query's top
  ``max(k, 8)`` lists by that maximum through the probe kernels
  (``ops/ivf.py``), with the mask folded into the selection. If a true top-k
  row's list were not among the top-k lists by masked maximum, k rows of
  better lists would beat it, so ``P >= k`` lists suffice.
- **compact** (``compact_gather`` + ``compact_topk_from_rows``): gather only
  the allowed rows once (the mask is the same for every query) and scan
  those exactly; its cost follows the allowed-set size, not the corpus.

Both score ``dot(bf16(q), row) * w`` with ``w = 0`` for invalid cells, in f32
products, and clamp cosine scores to 1.0 for every storage format, as the
single-chip reference does in both tiers. ``ivf_compact_masked_topk`` is the
compact tier in one call, on the reference's ``-1``-padded cell bucket.

Weight planes are ``[L, C]``; every entry point also takes the reference's
``[L, 8, C]`` (its TPU sublane copy) and reads its first row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from grape_vector_db_tpu_torch.ops.distance import prepare_queries
from grape_vector_db_tpu_torch.ops.int4 import unpack_int4
from grape_vector_db_tpu_torch.ops.ivf import (
    NEG_INF, _pad_k, finalize_probe_topk, ivf_probe_scores, ivf_probe_scores_int4,
    ivf_probe_scores_int8)

__all__ = ["ivf_exhaustive_masked_topk", "ivf_compact_masked_topk", "compact_gather",
           "compact_topk_from_rows", "compact_scan_core", "default_chunk_lists",
           "probe_dup_mask"]


def probe_dup_mask(probe: torch.Tensor) -> torch.Tensor:
    """[B, P] True where a probe entry repeats an earlier column's list id.
    ``torch.topk`` returns distinct lists, so here this is the reference's
    guard kept: a repeated list would duplicate its cells in the top-k."""
    p = probe.shape[1]
    pos = torch.arange(p, device=probe.device)
    earlier = pos[None, None, :] < pos[None, :, None]
    return torch.any((probe[:, :, None] == probe[:, None, :]) & earlier, dim=2)


# Each phase-1 chunk's [B, chunk_lists * C] plane stays at most this many cells.
_MAX_CHUNK_CELLS = 262_144


def default_chunk_lists(nlist: int, cap: int) -> int:
    """Largest power-of-two list count per phase-1 chunk that divides
    ``nlist`` and keeps chunk cells <= 262,144."""
    cl = 1
    while (cl * 2 <= nlist and nlist % (cl * 2) == 0
           and cl * 2 * cap <= _MAX_CHUNK_CELLS):
        cl *= 2
    return cl


def _dequant(dd: torch.Tensor, fmt: str) -> torch.Tensor:
    """Stored rows -> f32 values as the probe kernels see them: bf16 values
    (rows are rounded to bf16 in this format, as in the reference), int8
    codes, or int4 levels in -8..7."""
    if fmt == "bf16":
        return dd.to(torch.bfloat16).to(torch.float32)
    if fmt == "int8":
        return dd.to(torch.float32)
    if fmt == "int4":
        return unpack_int4(dd)
    raise ValueError(f"unknown scan format {fmt!r}")


_PROBES = {"bf16": ivf_probe_scores, "int8": ivf_probe_scores_int8,
           "int4": ivf_probe_scores_int4}


def _plane2d(plane: torch.Tensor) -> torch.Tensor:
    """A weight plane as ``[L, C]``: the reference's ``[L, 8, C]`` holds 8
    equal rows a list."""
    return plane[:, 0, :] if plane.dim() == 3 else plane


def ivf_exhaustive_masked_topk(
    queries: torch.Tensor,   # [B, D] f32 raw
    data: torch.Tensor,      # [L, C, D] bf16/f32 | [L, C, D] int8 | [L, C, D/2] packed
    plane: torch.Tensor,     # [L, C] f32 weight plane (recip / factor; 0 = invalid)
    mask: torch.Tensor,      # [L, C] bool filter (True = allowed)
    k: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    chunk_lists: int = 64,
    use_kernel: bool = False,
    interpret: bool = False,
    nblocks: Optional[torch.Tensor] = None,   # [L] occupied RB-row blocks
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k over every list of a bucketed IVF layout: (vals
    [B, k] f32, slots [B, k] int64 cell ids list * C + pos). Disallowed and
    invalid rows appear only as -inf tail padding. Phase 2 runs the probe
    kernel for CUDA tensors and its plain version for CPU ones, whatever
    ``use_kernel`` and ``interpret`` (the reference's TPU switches) say."""
    plane = _plane2d(plane)
    b = queries.shape[0]
    l, c = mask.shape
    qp = prepare_queries(queries, metric)
    qb = qp.to(torch.bfloat16).to(torch.float32)
    w_all = torch.where(mask, plane, 0.0)
    lmax = torch.empty((b, l), dtype=torch.float32, device=qp.device)
    for l0 in range(0, l, chunk_lists):
        cand = _dequant(data[l0:l0 + chunk_lists], fmt)            # [CL, C, D]
        dots = torch.einsum("bd,lcd->blc", qb, cand)
        w = w_all[l0:l0 + chunk_lists][None]
        sc = torch.where(w == 0.0, NEG_INF, dots * w)
        lmax[:, l0:l0 + chunk_lists] = sc.amax(dim=2)
    _, probe = torch.topk(lmax, min(l, max(k, 8)), dim=1)
    probe = probe.to(torch.int32)
    dup = probe_dup_mask(probe)
    scores = _PROBES[fmt](qp, probe, data, plane, nblocks=nblocks)
    scores = torch.where(dup[:, :, None], NEG_INF, scores)
    return finalize_probe_topk(qp, probe, scores, k, metric, cell_mask=mask)


def ivf_compact_masked_topk(
    queries: torch.Tensor,   # [B, D] f32 raw
    data: torch.Tensor,      # [L, C, D] bf16/f32 | [L, C, D] int8 | [L, C, D/2] packed
    plane: torch.Tensor,     # [L, C] (or [L, 8, C]) f32 weight plane; 0 = invalid
    cells,                   # [R] flat allowed cell ids list * C + pos; -1 = pad
    k: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    chunk_rows: int = 131_072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k by compaction: gather only the allowed rows, scan
    those: (vals [B, k] f32, slots [B, k] int64). ``cells`` is the
    reference's bucket, padded with -1; the pads are dropped before any
    index op (torch would read a -1 as the last cell). Slots past the
    allowed rows are -inf with slot 0."""
    cells = torch.as_tensor(cells, device=data.device).reshape(-1).to(torch.int64)
    cells = cells[cells >= 0]
    if cells.numel() == 0:
        b = queries.shape[0]
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=data.device),
                torch.zeros((b, k), dtype=torch.int64, device=data.device))
    rows, w = compact_gather(data, plane, cells)
    return compact_topk_from_rows(queries, rows, w, cells, k=k, metric=metric, fmt=fmt,
                                  chunk_rows=chunk_rows)


def compact_gather(data: torch.Tensor, plane: torch.Tensor,
                   cells: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The allowed rows (source dtype) and their score weights, for flat
    cell ids ``cells`` = list * C + pos. The reference pads ``cells`` to a
    power-of-two bucket with -1 (one compiled program per bucket); eager
    PyTorch needs no padding, so every entry is a real cell."""
    plane = _plane2d(plane)
    l, c = plane.shape
    flat = data.reshape((l * c,) + tuple(data.shape[2:]))
    return flat[cells], plane.reshape(-1)[cells]


def compact_scan_core(qb: torch.Tensor, rows: torch.Tensor, w: torch.Tensor, k: int,
                      fmt: str, chunk_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a compacted row block, ``chunk_rows`` rows at a time
    with a running top-k merge: (vals [B, kk] f32, idx [B, kk] int64 rows
    of ``rows``), kk = min(k, rows in the first chunk)."""
    r = rows.shape[0]
    cr = max(1, min(chunk_rows, r))
    kk = min(k, cr)
    vals = idx = None
    for off in range(0, r, cr):
        cand = _dequant(rows[off:off + cr], fmt)                    # [CR, D]
        ww = w[off:off + cr][None]
        sc = torch.where(ww == 0.0, NEG_INF, (qb @ cand.T) * ww)
        v, i = torch.topk(sc, min(kk, sc.shape[1]), dim=1)
        i = i + off
        if vals is not None:
            v = torch.cat([vals, v], dim=1)
            i = torch.cat([idx, i], dim=1)
            v, pos = torch.topk(v, kk, dim=1)
            i = torch.gather(i, 1, pos)
        vals, idx = v, i
    return vals, idx


def compact_topk_from_rows(
    queries: torch.Tensor,   # [B, D] f32 raw
    rows: torch.Tensor,      # [R, ...] gathered allowed rows (compact_gather)
    w: torch.Tensor,         # [R] f32 score weights (0 = invalid)
    cells: torch.Tensor,     # [R] flat cell ids list * C + pos
    k: int,
    metric: str = "cosine",
    fmt: str = "bf16",
    chunk_rows: int = 131_072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan stage of the compact tier: (vals [B, k], slots [B, k] int64)."""
    qp = prepare_queries(queries, metric)
    qb = qp.to(torch.bfloat16).to(torch.float32)
    vals, idx = compact_scan_core(qb, rows, w, k=k, fmt=fmt, chunk_rows=chunk_rows)
    slots = cells.to(torch.int64)[idx]
    if metric == "cosine":
        vals = torch.clamp(vals, max=1.0)
    vals = torch.where(torch.isfinite(vals), vals, NEG_INF)
    return _pad_k(vals, slots, k)

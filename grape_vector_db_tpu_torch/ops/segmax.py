"""Segment top-k kernels for exact large-corpus search, and their phase 2.

PyTorch counterpart of ``grape_vector_db_tpu/ops/segmax_pallas.py``. Phase 1
scores the whole corpus against the query batch and keeps, for every 32-row
segment, only its top few values and the member index of the top ranks; the
``[B, N]`` score plane never leaves the kernel. Phase 2 picks candidate rows
from those planes and rescores a handful of segments exactly.

Segments are strided and block-major, as in the reference: segment
``g = blk * 128 + j`` holds rows ``blk * 4096 + j + 128 * m`` for m < 32, so
the planes compare one to one with the Pallas kernels' interpret-mode output.
The contiguous layout (``segmax_scores_contig``) has segment g = rows
``32 * g .. 32 * g + 31`` instead.

Phase 1 has two implementations of each contract: hand-written CUDA
kernels, built with ``nvcc`` at first use into
``grape_vector_db_tpu_torch/_build/`` and called through a plain C
interface, and the plain PyTorch versions (``*_ref``). In bf16 storage every
instance runs the persistent TMA + wgmma kernel of ``csrc/segmax_max.cu``
(one main loop; a top-4, top-2 or maximum epilogue, the top-2 one also with
the members walked in bit-reversed order for B8, the top-4 one also folding
B7's block maxima); in f32 storage every instance runs the template of
``csrc/segmax.cu`` (``_library`` names the source). Wrapper, the TPU kernel
it replaces, ``LAUNCHES`` key:

- ``segmax4_scores``: B1 ``_segmax4_kernel``, ``segmax4``;
- ``segmax2_scores``: B2 ``_segmax2_kernel``, ``segmax2``;
- ``segmax2_scores(impl="selfold")``: B8 ``_segmax2_kernel_selfold``,
  ``segmax2_selfold``;
- ``segmax4_sup_scores``: B7 ``_segmax4_sup_kernel``, ``segmax4_sup``;
- ``segmax_scores``: B9 ``_segmax_kernel``, ``segmax``;
- ``segmax_scores_contig``: B10 ``_segmax_kernel_contig``, ``segmax_contig``.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Each launch adds one to
``LAUNCHES``. The entry points ``segmax_topk``, ``segmax4_topk`` and
``segmax2_topk`` run phase 1 and phase 2; ``ops/distance.scored_topk``
routes only to B1 and B2, as the reference does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from grape_vector_db_tpu_torch.ops import _build
from grape_vector_db_tpu_torch.ops.distance import f32_dots, prepare_queries

__all__ = ["SEG", "CB", "LAUNCHES", "reset_launch_counts", "build_kernels", "build_max_kernel",
           "make_weight_plane", "segmax4_scores", "segmax4_scores_ref",
           "segmax2_scores", "segmax2_scores_ref", "segmax_scores",
           "segmax_scores_ref", "segmax_scores_contig", "segmax_scores_contig_ref",
           "segmax4_sup_scores", "segmax4_sup_scores_ref", "segmax_topk",
           "segmax4_topk", "segmax2_topk"]

SEG = 32          # rows per segment
CB = 4096         # rows per corpus block
SPB = CB // SEG   # segments per corpus block (128)

NEG_INF = float("-inf")

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES: Dict[str, int] = {"segmax4": 0, "segmax2": 0, "segmax": 0, "segmax_contig": 0,
                            "segmax2_selfold": 0, "segmax4_sup": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- building and binding the CUDA kernels -------------------------------------

#: What the build did: library path, seconds, compiler log (ptxas -v).
BUILD_INFO: Dict[str, object] = _build.BUILD_INFO.setdefault("segmax", {})


def _bind(lib: ctypes.CDLL) -> None:
    lib.gvdb_segmax.restype = ctypes.c_int
    lib.gvdb_segmax.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.gvdb_segmax_variant.restype = ctypes.c_int
    lib.gvdb_segmax_variant.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])


def build_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/segmax.cu``."""
    return _build.load("segmax", _bind)


def _bind_max(lib: ctypes.CDLL) -> None:
    lib.gvdb_segmax_max.restype = ctypes.c_int
    lib.gvdb_segmax_max.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gvdb_segmax_max_smem_bytes.restype = ctypes.c_int
    lib.gvdb_segmax_max_smem_bytes.argtypes = []


def build_max_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/segmax_max.cu``."""
    return _build.load("segmax_max", _bind_max)


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# (top-j, variant) -> LAUNCHES key: B1, B2, B9, B10, B8, B7
_INSTANCES = {(4, "plain"): "segmax4", (2, "plain"): "segmax2", (1, "plain"): "segmax",
              (1, "contig"): "segmax_contig", (2, "selfold"): "segmax2_selfold",
              (4, "sup"): "segmax4_sup"}

#: the variant codes of both sources' C entries (their enum Variant)
_VARIANT_CODE = {"plain": 0, "contig": 1, "selfold": 2, "sup": 3}


def _library(instance: Tuple[int, str], dtype: torch.dtype) -> str:
    """The source whose kernel an instance ((top-j, variant), a key of
    ``_INSTANCES``) launches: in bf16 storage ``segmax_max``, the TMA +
    wgmma kernel; in f32 storage the ``segmax`` template."""
    if instance not in _INSTANCES:
        raise KeyError(f"no segment kernel instance {instance!r}")
    return "segmax_max" if dtype == torch.bfloat16 else "segmax"


def _launch(topj: int, q: torch.Tensor, vectors: torch.Tensor, w: torch.Tensor,
            variant: str = "plain") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one kernel instance: values [topj, B, N/SEG] f32 (contig:
    [N/SEG, B]), member indices [topj-1, B, N/SEG] int32, and block maxima
    [2, B, N/CB] f32 (sup; empty otherwise)."""
    name = _INSTANCES[(topj, variant)]
    dev = vectors.device
    if dev.type != "cuda" or q.device != dev or w.device != dev:
        raise ValueError(f"{name}: q, vectors and w must lie on one CUDA device")
    if vectors.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: storage dtype {vectors.dtype} has no kernel "
                         "(bfloat16 and float32 do)")
    b, d = q.shape
    n = vectors.shape[0]
    if vectors.shape[1] != d or w.shape != (n,):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, vectors "
                         f"{tuple(vectors.shape)}, w {tuple(w.shape)} disagree")
    if n % CB or n // CB > 65535 or d % 128 or b < 1:
        raise ValueError(f"{name}: needs N % {CB} == 0 (N <= {CB * 65535}), "
                         f"D % 128 == 0 and B >= 1; got N={n}, D={d}, B={b}")
    qc = q.to(vectors.dtype).contiguous()
    wc = w.to(torch.float32).contiguous()
    if not vectors.is_contiguous():
        raise ValueError(f"{name}: vectors must be contiguous")
    library = _library((topj, variant), vectors.dtype)
    # the template loads q and vectors 16 bytes at a time; TMA also reads w
    for t in (qc, vectors, wc) if library == "segmax_max" else (qc, vectors):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q, vectors (and for TMA, w) must be 16-byte aligned")
    shape = (n // SEG, b) if variant == "contig" else (topj, b, n // SEG)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idxs = torch.empty((topj - 1, b, n // SEG), dtype=torch.int32, device=dev)
    sup = torch.empty((2, b, n // CB) if variant == "sup" else (0,),
                      dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (_DTYPE_CODE[vectors.dtype], dev.index or 0, qc.data_ptr(), vectors.data_ptr(),
            wc.data_ptr(), vals.data_ptr(), idxs.data_ptr())
    code = _VARIANT_CODE[variant]
    if library == "segmax_max":        # bf16 only
        lib = build_max_kernel()
        rc = lib.gvdb_segmax_max(code, topj, *args[1:], sup.data_ptr(), b, n, d, stream)
    else:                              # f32 only; B1 and B2 through gvdb_segmax
        lib = build_kernels()
        rc = (lib.gvdb_segmax(topj, *args, b, n, d, stream) if variant == "plain" and topj > 1
              else lib.gvdb_segmax_variant(code, *args, sup.data_ptr(), b, n, d, stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.gvdb_cuda_error_string(rc).decode()} ({rc})")
    LAUNCHES[name] += 1
    return vals, idxs, sup


# -- plain PyTorch versions ---------------------------------------------------


def make_weight_plane(norms: torch.Tensor, valid: torch.Tensor,
                      metric: str = "cosine") -> torch.Tensor:
    """[N] norms + validity -> [N] f32 score weight (0 = invalid row)."""
    if metric == "cosine":
        w = 1.0 / torch.clamp(norms.to(torch.float32), min=1e-12)
    else:
        w = torch.ones_like(norms, dtype=torch.float32)
    return torch.where(valid, w, 0.0)


def _scores(q: torch.Tensor, vectors: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 weighted scores, -inf where w == 0 (the kernels' contract)."""
    n = vectors.shape[0]
    if n % CB:
        raise ValueError(f"N={n} must be a multiple of {CB}")
    s = f32_dots(q, vectors)
    return torch.where(w[None, :] == 0, NEG_INF, s * w[None, :])


def _bitrev5(x: int) -> int:
    return int(f"{x:05b}"[::-1], 2)


#: the members in the order the selfold rule prefers them on a tie: position
#: p holds the member whose 5-bit bit-reversed index is p
_SELFOLD_ORDER = [_bitrev5(p) for p in range(SEG)]


def _sorted_segments(q: torch.Tensor, vectors: torch.Tensor, w: torch.Tensor,
                     topj: int, order: Optional[list] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores in f32, viewed as [B, blocks, member, segment]; members sorted
    by score descending, ties in ``order`` (a list of the members; default
    ascending) — a stable descending sort over the members so permuted."""
    b = q.shape[0]
    n = vectors.shape[0]
    s = _scores(q, vectors, w)
    s = s.view(b, n // CB, SEG, SPB).transpose(2, 3)        # member axis last
    if order is not None:
        s = s[..., order]
    vals, pos = torch.sort(s, dim=-1, descending=True, stable=True)
    pos = pos[..., :topj - 1]
    if order is not None:
        pos = torch.tensor(order, device=pos.device)[pos]
    vals = vals[..., :topj].reshape(b, n // SEG, topj)
    return vals, pos.reshape(b, n // SEG, topj - 1).to(torch.int32)


def segmax4_scores_ref(q: torch.Tensor, vectors: torch.Tensor,
                       w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of the top-4 kernel: (m1, m2, m3, m4, i1, i2, i3), each
    [B, N/SEG]; values f32, member indices int32."""
    vals, order = _sorted_segments(q, vectors, w, 4)
    return (tuple(vals[..., t].contiguous() for t in range(4))
            + tuple(order[..., t].contiguous() for t in range(3)))


def segmax2_scores_ref(q: torch.Tensor, vectors: torch.Tensor, w: torch.Tensor,
                       impl: str = "eqfold") -> Tuple[torch.Tensor, ...]:
    """Plain version of the top-2 kernels: (m1, i1, m2), each [B, N/SEG].
    ``impl="eqfold"`` (B2): among tied maxima i1 is the smallest member;
    ``"selfold"`` (B8): the member with the smallest 5-bit bit-reversed
    index, the rule of the reference's fold, which keeps the lower half at
    each of its five halvings. The values are the same."""
    vals, order = _sorted_segments(q, vectors, w, 2, order=_impl_order(impl))
    return (vals[..., 0].contiguous(), order[..., 0].contiguous(),
            vals[..., 1].contiguous())


def _impl_order(impl: str) -> Optional[list]:
    if impl not in ("eqfold", "selfold"):
        raise ValueError(f"unknown segmax2 impl {impl!r} (eqfold or selfold)")
    return _SELFOLD_ORDER if impl == "selfold" else None


def segmax_scores_ref(q: torch.Tensor, vectors: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain version of B9: [B, N/SEG] f32 strided segment maxima."""
    b, n = q.shape[0], vectors.shape[0]
    s = _scores(q, vectors, w).view(b, n // CB, SEG, SPB)
    return s.amax(dim=2).reshape(b, n // SEG)


def segmax_scores_contig_ref(q: torch.Tensor, vectors: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Plain version of B10: [N/SEG, B] f32 maxima over contiguous 32-row
    segments (segment g = rows 32 g .. 32 g + 31), transposed as the
    reference's output is."""
    b, n = q.shape[0], vectors.shape[0]
    s = _scores(q, vectors, w).view(b, n // SEG, SEG)
    return s.amax(dim=2).T.contiguous()


def _block_maxima(plane: torch.Tensor) -> torch.Tensor:
    """[B, N/SEG] segment plane -> [B, N/CB] maxima over each block's segments."""
    b = plane.shape[0]
    return plane.view(b, -1, SPB).amax(dim=2)


def segmax4_sup_scores_ref(q: torch.Tensor, vectors: torch.Tensor,
                           w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of B7: B1's seven planes, then s1 and s2 [B, N/CB],
    the maxima of m1 and m2 over each block's 128 segments (-inf for a
    block with no valid row)."""
    planes = segmax4_scores_ref(q, vectors, w)
    return planes + (_block_maxima(planes[0]), _block_maxima(planes[1]))


def segmax4_scores(q: torch.Tensor, vectors: torch.Tensor,
                   w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(m1, m2, m3, m4, i1, i2, i3), [B, N/SEG] each, for q [B, D] f32
    (prepared), vectors [N, D] and w [N] f32. CUDA tensors run the kernel."""
    if vectors.device.type == "cpu":
        return segmax4_scores_ref(q, vectors, w)
    vals, idxs, _ = _launch(4, q, vectors, w)
    return tuple(vals.unbind(0)) + tuple(idxs.unbind(0))


def segmax2_scores(q: torch.Tensor, vectors: torch.Tensor, w: torch.Tensor,
                   impl: str = "eqfold") -> Tuple[torch.Tensor, ...]:
    """(m1, i1, m2), [B, N/SEG] each; ``impl`` picks the tie rule of i1
    (``segmax2_scores_ref``). CUDA tensors run B2 (eqfold) or B8 (selfold)."""
    _impl_order(impl)
    if vectors.device.type == "cpu":
        return segmax2_scores_ref(q, vectors, w, impl=impl)
    vals, idxs, _ = _launch(2, q, vectors, w, "selfold" if impl == "selfold" else "plain")
    return vals[0], idxs[0], vals[1]


def segmax_scores(q: torch.Tensor, vectors: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, N/SEG] strided segment maxima. CUDA tensors run B9."""
    if vectors.device.type == "cpu":
        return segmax_scores_ref(q, vectors, w)
    return _launch(1, q, vectors, w)[0][0]


def segmax_scores_contig(q: torch.Tensor, vectors: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """[N/SEG, B] contiguous segment maxima. CUDA tensors run B10."""
    if vectors.device.type == "cpu":
        return segmax_scores_contig_ref(q, vectors, w)
    return _launch(1, q, vectors, w, "contig")[0]


def segmax4_sup_scores(q: torch.Tensor, vectors: torch.Tensor,
                       w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(m1, m2, m3, m4, i1, i2, i3, s1, s2): B1's planes and the block
    maxima of m1 and m2 [B, N/CB]. CUDA tensors run B7."""
    if vectors.device.type == "cpu":
        return segmax4_sup_scores_ref(q, vectors, w)
    vals, idxs, sup = _launch(4, q, vectors, w, "sup")
    return tuple(vals.unbind(0)) + tuple(idxs.unbind(0)) + tuple(sup.unbind(0))


# -- phase 2 ------------------------------------------------------------------


def _dup_pick_mask(seg: torch.Tensor) -> torch.Tensor:
    """[B, r] bool: True where this segment id already appeared at an earlier
    position in the same row. ``torch.topk`` returns distinct positions, so
    with it this is a no-op; it stays as the reference's guard against a
    selection that repeats a pick over an all -inf plane (reference
    ``_dup_pick_mask``), which would rescore the same rows twice."""
    r = seg.shape[1]
    pos = torch.arange(r, device=seg.device)
    earlier = pos[None, None, :] < pos[None, :, None]
    return torch.any((seg[:, :, None] == seg[:, None, :]) & earlier, dim=2)


def _member_rows(ij: torch.Tensor, segj: torch.Tensor) -> torch.Tensor:
    """Global row of the recorded member of each chosen segment."""
    mem = torch.gather(ij, 1, segj).to(torch.int64)
    return (segj // SPB) * CB + segj % SPB + mem * SPB


def _segment_rows(seg: torch.Tensor) -> torch.Tensor:
    """[B, r] segment ids -> [B, r * SEG] rows of all their members."""
    b, r = seg.shape
    mm = torch.arange(SEG, device=seg.device)
    rows = ((seg // SPB)[:, :, None] * CB + (seg % SPB)[:, :, None]
            + mm[None, None, :] * SPB)
    return rows.reshape(b, r * SEG)


def _rescore(q: torch.Tensor, vectors: torch.Tensor, norms: torch.Tensor,
             valid: torch.Tensor, rows: torch.Tensor, metric: str,
             cvecs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact scores of [B, C] gathered rows, in phase 1's arithmetic: f32
    products of the stored values times the masked weight (multiplied,
    never divided). ``cvecs`` may hold the rows already gathered ([B, C, D]).
    The gathered rows are few, so both operands are upcast to f32 (bf16
    products are exact)."""
    if cvecs is None:
        cvecs = vectors[rows]
    cvecs = cvecs.to(torch.float32)                         # [B, C, D]
    qc = q.to(vectors.dtype).to(torch.float32)
    dots = torch.bmm(cvecs, qc[:, :, None])[:, :, 0]        # [B, C]
    w = make_weight_plane(norms[rows], valid[rows], metric)
    rs = torch.where(w == 0, NEG_INF, dots * w)
    if metric == "cosine":
        rs = torch.clamp(rs, max=1.0)
    return rs


def _clamp(v: torch.Tensor, metric: str) -> torch.Tensor:
    return torch.clamp(v, max=1.0) if metric == "cosine" else v


_SELECTS = ("auto", "iterative", "twolevel")


def _check_select(select: str, allowed=_SELECTS) -> None:
    """The reference's ``select`` picks among its TPU selection engines
    (iterative max-and-mask, supersegment two-level, verified approx). The
    port accepts the same values and selects with ``torch.topk``, which is
    exact, for every one of them: a deliberate difference, as for
    ``search_mode="approx"``."""
    if select not in allowed:
        raise ValueError(f"unknown select {select!r} (one of {', '.join(allowed)})")


def _topk(plane: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.topk(plane, r, dim=1)


def _twolevel_topk_pre(plane: torch.Tensor, kk: int,
                       sup: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-kk over [B, W] ``plane`` from its block maxima ``sup``
    [B, ns] (reference ``_twolevel_topk_pre`` / ``_twolevel_from_sup``): the
    top-kk blocks on ``sup``, then the top-kk over those blocks' contiguous
    children. A top-kk value's block bounds it from above, so kk better
    blocks would hold kk better values; ties at the k-th value are
    interchangeable. Falls back to the full-plane selection when
    ns < kk."""
    b, w = plane.shape
    ns = sup.shape[1]
    if ns < kk or w % ns:
        return _topk(plane, kk)
    fan = w // ns
    _, blks = torch.topk(sup, kk, dim=1)                    # [B, kk]
    cvals = torch.gather(plane.view(b, ns, fan), 1,
                         blks[:, :, None].expand(b, kk, fan))
    # a repeated block would enter twice; torch.topk picks distinct ones, so
    # this is the reference's guard kept for its contract
    cvals = torch.where(_dup_pick_mask(blks)[:, :, None], NEG_INF, cvals)
    child = (blks[:, :, None] * fan
             + torch.arange(fan, device=plane.device)[None, None, :]).reshape(b, kk * fan)
    tv, tp = torch.topk(cvals.reshape(b, kk * fan), kk, dim=1)
    return tv, torch.gather(child, 1, tp)


def segmax_topk(
    queries: torch.Tensor,   # [B, D] f32 raw
    vectors: torch.Tensor,   # [N, D] storage dtype, N % 4096 == 0
    norms: torch.Tensor,     # [N] f32
    valid: torch.Tensor,     # [N] bool
    k: int,
    metric: str = "cosine",
    mask: Optional[torch.Tensor] = None,  # [N] bool filter (True = allowed)
    layout: str = "strided",
    select: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via segment maxima (reference ``pallas_segmax_topk``):
    phase 1 keeps each 32-row segment's maximum (B9 for ``layout=
    "strided"``, B10 for ``"contig"``), phase 2 rescores every member of
    the top-k segments. If a true top-k row lay outside them, k segments
    would each hold a larger row. Contiguous segments are gathered as one
    [32, D] slice each. ``select`` takes the reference's values
    ("auto", "iterative", "verified", "twolevel"); every one selects
    exactly with ``torch.topk``. Returns min(k, 32 * min(k, N/32)) columns."""
    if layout not in ("strided", "contig"):
        raise ValueError(f"unknown layout {layout!r} (strided or contig)")
    _check_select(select, _SELECTS + ("verified",))
    n, d = vectors.shape
    b = queries.shape[0]
    if mask is not None:
        valid = torch.logical_and(valid, mask)
    q = prepare_queries(queries, metric)
    w = make_weight_plane(norms, valid, metric)
    if layout == "contig":
        segmax = segmax_scores_contig(q, vectors, w).T      # [B, N/SEG]
    else:
        segmax = segmax_scores(q, vectors, w)
    kk = min(k, n // SEG)
    _, seg = _topk(segmax, kk)
    if layout == "contig":
        rows = (seg[:, :, None] * SEG
                + torch.arange(SEG, device=seg.device)[None, None, :]).reshape(b, kk * SEG)
        cvecs = vectors.view(n // SEG, SEG, d)[seg].reshape(b, kk * SEG, d)
    else:
        rows = _segment_rows(seg)
        cvecs = None
    rs = _rescore(q, vectors, norms, valid, rows, metric, cvecs)
    rs = torch.where(torch.repeat_interleave(_dup_pick_mask(seg), SEG, dim=1),
                     NEG_INF, rs)
    fvals, fpos = torch.topk(rs, min(k, rs.shape[1]), dim=1)
    return fvals, torch.gather(rows, 1, fpos)


def segmax4_topk(
    queries: torch.Tensor,   # [B, D] f32 raw
    vectors: torch.Tensor,   # [N, D] storage dtype
    norms: torch.Tensor,     # [N] f32
    valid: torch.Tensor,     # [N] bool
    k: int,
    metric: str = "cosine",
    mask: Optional[torch.Tensor] = None,  # [N] bool filter (True = allowed)
    select: str = "auto",
    impl: str = "plain",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via the top-4-per-segment kernel (reference
    ``pallas_segmax4_topk``): ranks 1..3 of every segment are known
    candidates (value + member index from the kernel, no gather), and only
    the top-floor(k/4) segments by fourth value are fully rescored.

    ``impl="plain"`` runs B1; ``"sup"`` runs B7, which also emits the block
    maxima of the m1 and m2 planes, and the two full-plane selections start
    from them (``_twolevel_topk_pre``). The result is the same. ``select``
    as in ``segmax_topk``.

    Exactness: let tau be the true k-th score. A top-k row at rank j within
    its segment s has m_j(s) >= tau, and s holds j rows >= tau, so at most
    floor(k/j) segments can hold a rank-j top-k row; the top floor(k/j)
    segments by m_j surface it. Only the m1 and m2 planes are selected in
    full: m2 >= m3 >= m4, so the rank-3 pool and the rescore set are found
    within the m2-top-floor(k/2) segments. Boundary ties are interchangeable
    by value."""
    if impl not in ("plain", "sup"):
        raise ValueError(f"unknown segmax4 impl {impl!r} (plain or sup)")
    _check_select(select)
    n, d = vectors.shape
    if mask is not None:
        valid = torch.logical_and(valid, mask)
    q = prepare_queries(queries, metric)
    w = make_weight_plane(norms, valid, metric)
    sel_m1 = sel_m2 = _topk
    if impl == "sup":
        m1, m2, m3, m4, i1, i2, i3, s1, s2 = segmax4_sup_scores(q, vectors, w)
        sel_m1 = functools.partial(_twolevel_topk_pre, sup=s1)
        sel_m2 = functools.partial(_twolevel_topk_pre, sup=s2)
    else:
        m1, m2, m3, m4, i1, i2, i3 = segmax4_scores(q, vectors, w)
    num_seg = n // SEG
    kk = min(k, num_seg)

    v1, seg1 = sel_m1(m1, kk)
    pools_v = [_clamp(v1, metric)]
    pools_rows = [_member_rows(i1, seg1)]
    pools_seg = [seg1]
    r2 = min(kk // 2, num_seg)
    r3 = min(kk // 3, r2)
    r4 = min(kk // 4, r2)
    if r2:
        v2, seg2 = sel_m2(m2, r2)
        pools_v.append(_clamp(v2, metric))
        pools_rows.append(_member_rows(i2, seg2))
        pools_seg.append(seg2)
        dup2 = _dup_pick_mask(seg2)                             # [B, r2]
    if r3:
        m3_at = torch.where(dup2, NEG_INF, torch.gather(m3, 1, seg2))
        v3, p3 = torch.topk(m3_at, r3, dim=1)
        seg3 = torch.gather(seg2, 1, p3)
        pools_v.append(_clamp(v3, metric))
        pools_rows.append(_member_rows(i3, seg3))
        pools_seg.append(seg3)
    if r4 == 0:
        cand_vals = torch.cat(pools_v, dim=1)
        cand_rows = torch.cat(pools_rows, dim=1)
        fvals, fpos = torch.topk(cand_vals, kk, dim=1)
        return fvals, torch.gather(cand_rows, 1, fpos)

    m4_at = torch.where(dup2, NEG_INF, torch.gather(m4, 1, seg2))
    _, p4 = torch.topk(m4_at, r4, dim=1)
    seg4 = torch.gather(seg2, 1, p4)               # segments needing rescore
    rows4 = _segment_rows(seg4)                    # [B, r4*SEG]
    rs = _rescore(q, vectors, norms, valid, rows4, metric)
    rs = torch.where(torch.repeat_interleave(_dup_pick_mask(seg4), SEG, dim=1),
                     NEG_INF, rs)
    # dedup: known candidates whose segment is fully rescored appear twice —
    # mask the known copy (the rescore copy carries the same value)
    for i in range(len(pools_v)):
        dup = torch.any(pools_seg[i][:, :, None] == seg4[:, None, :], dim=2)
        pools_v[i] = torch.where(dup, NEG_INF, pools_v[i])

    cand_vals = torch.cat(pools_v + [rs], dim=1)
    cand_rows = torch.cat(pools_rows + [rows4], dim=1)
    fvals, fpos = torch.topk(cand_vals, kk, dim=1)
    return fvals, torch.gather(cand_rows, 1, fpos)


def segmax2_topk(
    queries: torch.Tensor,   # [B, D] f32 raw
    vectors: torch.Tensor,   # [N, D] storage dtype
    norms: torch.Tensor,     # [N] f32
    valid: torch.Tensor,     # [N] bool
    k: int,
    metric: str = "cosine",
    mask: Optional[torch.Tensor] = None,  # [N] bool filter (True = allowed)
    select: str = "auto",
    impl: str = "eqfold",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via the top-2-per-segment kernel (reference
    ``pallas_segmax2_topk``): candidates are the top-k segment argmaxes
    (values already exact, no gather) plus a full rescore of the
    top-floor(k/2) segments by second value. A top-k row that is not its
    segment's argmax has m2(s) >= tau, and more than floor(k/2) such
    segments would hold more than k rows >= tau. For k == 1 no row is
    gathered at all. ``impl="eqfold"`` runs B2, ``"selfold"`` B8 (another
    member on ties, the same values); ``select`` as in ``segmax_topk``."""
    _check_select(select)
    n, d = vectors.shape
    if mask is not None:
        valid = torch.logical_and(valid, mask)
    q = prepare_queries(queries, metric)
    w = make_weight_plane(norms, valid, metric)
    m1, i1, m2 = segmax2_scores(q, vectors, w, impl)
    num_seg = n // SEG
    kk = min(k, num_seg)
    v1, seg1 = torch.topk(m1, kk, dim=1)             # candidate argmax rows
    rows1 = _member_rows(i1, seg1)
    v1 = _clamp(v1, metric)
    r = min(kk // 2, num_seg)
    if r == 0:
        return v1, rows1

    _, seg2 = torch.topk(m2, r, dim=1)               # segments needing rescore
    rows2 = _segment_rows(seg2)
    rs = _rescore(q, vectors, norms, valid, rows2, metric)
    rs = torch.where(torch.repeat_interleave(_dup_pick_mask(seg2), SEG, dim=1),
                     NEG_INF, rs)
    # dedup: argmax candidates whose segment is fully rescored would appear
    # twice — mask the m1 copy (the rescore copy carries the same value)
    dup = torch.any(seg1[:, :, None] == seg2[:, None, :], dim=2)
    v1 = torch.where(dup, NEG_INF, v1)

    cand_vals = torch.cat([v1, rs], dim=1)
    cand_rows = torch.cat([rows1, rows2], dim=1)
    fvals, fpos = torch.topk(cand_vals, kk, dim=1)
    return fvals, torch.gather(cand_rows, 1, fpos)

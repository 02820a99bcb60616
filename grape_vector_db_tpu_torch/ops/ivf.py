"""Ragged IVF probe: score every query's probed lists, then select.

PyTorch counterpart of ``grape_vector_db_tpu/ops/ivf_pallas.py``. A probe
cell is one (query b, probe slot p) pair; it scores the rows of list
``l = probe[b, p]`` below the list's high-water mark against query b and
weights each score by the list's weight plane ``w`` ([L, C] f32: 1/|v| for
cosine, 1 for dot, the dequant scale folded in for codes; 0 marks a free or
deleted cell). Invalid cells score -1e9; the selection turns them into -inf.

The probe has two implementations of one contract for each storage format:

- the hand-written CUDA kernels in ``csrc/ivf_probe.cu``, built with
  ``nvcc`` at first use (``ops/_build.py``) and called through a plain C
  interface: one template for bf16 and f32 rows (``_probe_kernel``), one
  block a cell; for int8 codes (``_probe_kernel_int8``) and packed int4
  (``_probe_kernel_int4``) a grouping pass that sorts the cells by list
  (``group_cells``), then a kernel that streams each list once for up to 8
  of its cells and takes the product on the tensor cores (int8: a
  persistent grid fed by TMA copies on mbarriers; int4: one block a
  group);
- the plain PyTorch versions ``ivf_probe_scores_ref``,
  ``ivf_probe_scores_int8_ref``, ``ivf_probe_scores_int4_ref`` and
  ``group_cells_ref``.

``ivf_probe_scores*`` and ``group_cells`` take the plain version only for
tensors on the CPU; for a CUDA tensor they launch the kernel or raise. Each
launch adds one to ``LAUNCHES`` (an int8 or int4 probe adds one to
``"ivf_probe_int8"`` or ``"ivf_probe_int4"`` and one to ``"ivf_group"``, its
grouping pass). The
reference's per-call VMEM chunking of the probe axis and the 8-sublane
broadcast of the weight planes were TPU artefacts and are gone: planes are
``[L, C]``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from grape_vector_db_tpu_torch.ops import _build
from grape_vector_db_tpu_torch.ops.distance import prepare_queries
from grape_vector_db_tpu_torch.ops.int4 import unpack_int4_split

__all__ = ["RB", "LAUNCHES", "reset_launch_counts", "build_kernels",
           "nblocks_from_counts", "make_recip", "make_factor", "group_cells",
           "group_cells_ref",
           "finalize_probe_topk",
           "ivf_probe_scores", "ivf_probe_scores_ref",
           "ivf_probe_scores_int8", "ivf_probe_scores_int8_ref",
           "ivf_probe_scores_int4", "ivf_probe_scores_int4_ref",
           "ivf_topk", "ivf_topk_int8", "ivf_topk_int4"]

#: Rows per ``nblocks`` unit, for every storage format.
RB = 64
INVALID = -1e9
NEG_INF = float("-inf")
#: Largest query dim the CUDA kernel stages (48 KB of shared memory).
MAX_DIM = 12288

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES: Dict[str, int] = {"ivf_probe": 0, "ivf_probe_int8": 0, "ivf_probe_int4": 0,
                             "ivf_group": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- building and binding the CUDA kernels -------------------------------------

#: What the build did: library path, seconds, compiler log (ptxas -v).
BUILD_INFO: Dict[str, object] = _build.BUILD_INFO.setdefault("ivf_probe", {})


def _bind(lib: ctypes.CDLL) -> None:
    lib.gvdb_ivf_probe.restype = ctypes.c_int
    lib.gvdb_ivf_probe.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.gvdb_ivf_group.restype = ctypes.c_int
    lib.gvdb_ivf_group.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                                   + [ctypes.c_void_p] * 2)
    lib.gvdb_ivf_scratch_words.restype = ctypes.c_long
    lib.gvdb_ivf_scratch_words.argtypes = [ctypes.c_int] * 4
    lib.gvdb_ivf_order_word.restype = ctypes.c_long
    lib.gvdb_ivf_order_word.argtypes = [ctypes.c_int]
    lib.gvdb_ivf_int8_plan.restype = ctypes.c_int
    lib.gvdb_ivf_int8_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.gvdb_ivf_probe_int8, lib.gvdb_ivf_probe_int4):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])


def build_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/ivf_probe.cu``."""
    return _build.load("ivf_probe", _bind)


# format code (none for the grouped probes: their own C entries), bytes of
# a stored row per query dim, wrapper name
_FORMATS = {"bf16": (0, 2.0, "ivf_probe"), "f32": (1, 4.0, "ivf_probe"),
            "int8": (None, 1.0, "ivf_probe_int8"), "int4": (None, 0.5, "ivf_probe_int4")}


def _full_nblocks(l: int, c: int, device) -> torch.Tensor:
    return torch.full((l,), -(-c // RB), dtype=torch.int32, device=device)


def _launch(fmt: str, q: torch.Tensor, probe: torch.Tensor, data: torch.Tensor,
            w: torch.Tensor, nblocks: Optional[torch.Tensor]) -> torch.Tensor:
    """Run the probe kernel for ``fmt`` (int8, int4: the grouping pass,
    then the grouped kernel): [B, P, C] f32."""
    code, row_bytes_per_dim, name = _FORMATS[fmt]
    dev = data.device
    if dev.type != "cuda" or any(t.device != dev for t in (q, probe, w)):
        raise ValueError(f"{name}: q, probe, data and w must lie on one CUDA device")
    b, d = q.shape
    l, c = w.shape
    width = d // 2 if fmt == "int4" else d
    if (probe.ndim != 2 or probe.shape[0] != b or tuple(data.shape) != (l, c, width)
            or (fmt == "int4" and d % 2)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, probe {tuple(probe.shape)}, "
                         f"data {tuple(data.shape)}, w {tuple(w.shape)} disagree")
    row_bytes = row_bytes_per_dim * d
    if row_bytes % 16 or d > MAX_DIM or probe.shape[1] < 1 or b < 1:
        raise ValueError(f"{name}: needs rows of a multiple of 16 bytes and D <= {MAX_DIM}; "
                         f"got D={d} ({row_bytes:g} bytes a row), B={b}, P={probe.shape[1]}")
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError(f"{name}: data must be contiguous and 16-byte aligned")
    if nblocks is None:
        nblocks = _full_nblocks(l, c, dev)
    if nblocks.shape != (l,):
        raise ValueError(f"{name}: nblocks shape {tuple(nblocks.shape)} != ({l},): "
                         "stale layout? (list count changed since the counts were taken)")
    qc = q.to(torch.float32).contiguous()
    pc = probe.to(torch.int32).contiguous()
    wc = w.to(torch.float32).contiguous()
    nb = nblocks.to(device=dev, dtype=torch.int32).contiguous()
    lib = build_kernels()
    out = torch.empty((b, probe.shape[1], c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if code is None:    # the grouping pass, then the grouped kernel: one C call
        if qc.data_ptr() % 16:
            qc = qc.clone()
        scratch = torch.empty(lib.gvdb_ivf_scratch_words(probe.numel(), l, b, d),
                              dtype=torch.int32, device=dev)
        entry = lib.gvdb_ivf_probe_int8 if fmt == "int8" else lib.gvdb_ivf_probe_int4
        rc = entry(dev.index or 0, qc.data_ptr(), pc.data_ptr(), data.data_ptr(),
                   wc.data_ptr(), nb.data_ptr(), out.data_ptr(), scratch.data_ptr(), b,
                   probe.shape[1], l, c, d, stream)
        _raise_on(lib, rc, name)
        LAUNCHES["ivf_group"] += 1
    else:
        rc = lib.gvdb_ivf_probe(code, dev.index or 0, qc.data_ptr(), pc.data_ptr(),
                                data.data_ptr(), wc.data_ptr(), nb.data_ptr(), out.data_ptr(),
                                b, probe.shape[1], l, c, d, stream)
        _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def _raise_on(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.gvdb_cuda_error_string(rc).decode()} ({rc})")


# -- the grouped probes' grouping pass ---------------------------------------------


def group_cells_ref(probe: torch.Tensor, n_lists: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the grouping pass. The cells ``b * P + p`` of probe
    [B, P] sorted by their list: bin ``l`` holds the cells probing list l,
    bin ``n_lists`` those whose id lies outside ``[0, n_lists)``. Returns
    ``order`` [B * P] int32, the cells in a stable order by bin, and
    ``start`` [n_lists + 2] int32, bin k's first position (``start[k + 1] -
    start[k]`` cells)."""
    ids = probe.reshape(-1).to(torch.int64)
    bins = torch.where((ids >= 0) & (ids < n_lists), ids, n_lists)
    order = torch.argsort(bins, stable=True).to(torch.int32)
    counts = torch.bincount(bins, minlength=n_lists + 1)
    start = torch.zeros(n_lists + 2, dtype=torch.int64, device=probe.device)
    start[1:] = torch.cumsum(counts, 0)
    return order, start.to(torch.int32)


def group_cells(probe: torch.Tensor, n_lists: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, start)`` as ``group_cells_ref`` defines them, except that on
    the card the cells of one bin come in any order (a counting sort with
    atomics). On a CUDA tensor the hand-written pass of ``csrc/ivf_probe.cu``
    (one launch, counted in ``LAUNCHES["ivf_group"]``; the int8 and int4
    probes run the same pass inside their own C calls) or raises; on a CPU
    tensor ``group_cells_ref``."""
    if probe.device.type == "cpu":
        return group_cells_ref(probe, n_lists)
    n = probe.numel()
    if probe.dtype != torch.int32 or n < 1 or n_lists < 1:
        raise ValueError(f"group_cells: probe must be non-empty int32, got {probe.dtype} "
                         f"{tuple(probe.shape)} over {n_lists} lists")
    pc = probe.contiguous()
    lib = build_kernels()
    scratch = torch.empty(lib.gvdb_ivf_scratch_words(n, n_lists, 0, 0), dtype=torch.int32,
                          device=probe.device)
    _raise_on(lib, lib.gvdb_ivf_group(
        probe.device.index or 0, pc.data_ptr(), n, n_lists, scratch.data_ptr(),
        torch.cuda.current_stream(probe.device).cuda_stream), "ivf_group")
    LAUNCHES["ivf_group"] += 1
    first = lib.gvdb_ivf_order_word(n_lists)
    return scratch[first:first + n], scratch[:n_lists + 2]


# -- plain PyTorch versions ---------------------------------------------------

# Elements of the gathered f32 rows one step of a plain version holds (512 MB).
_REF_CHUNK_ELEMS = 1 << 27


def _probe_ref(fmt: str, q: torch.Tensor, probe: torch.Tensor, data: torch.Tensor,
               w: torch.Tensor, nblocks: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernels' contract with gathers and einsums, a few queries at a
    time: q rounded to bf16 (not for f32 rows), f32 products, and for int4
    the nibbles u in 0..15 with dot - 8 * sum(q) (``csrc/ivf_probe.cu``); a
    probe id outside [0, L) scores -1e9 on its whole cell."""
    b, d = q.shape
    l, c = w.shape
    p = probe.shape[1]
    probe = probe.to(torch.int64)
    known = (probe >= 0) & (probe < l)                     # [B, P]
    probe = torch.where(known, probe, 0)
    qf = q.to(torch.float32)
    if fmt != "f32":
        qf = qf.to(torch.bfloat16).to(torch.float32)
    if nblocks is None:
        nblocks = _full_nblocks(l, c, w.device)
    lim = torch.clamp(torch.clamp(nblocks.to(torch.int64), min=0) * RB, max=c)   # [L]
    pos = torch.arange(c, device=w.device)
    out = torch.empty((b, p, c), dtype=torch.float32, device=w.device)
    step = max(1, _REF_CHUNK_ELEMS // max(p * c * d, 1))
    for b0 in range(0, b, step):
        pr = probe[b0:b0 + step]
        qs = qf[b0:b0 + step]
        rows = data[pr]                                     # [bs, P, C, width]
        if fmt == "int4":
            lo, hi = unpack_int4_split(rows)
            h = d // 2
            dots = (torch.einsum("bd,bpcd->bpc", qs[:, :h], lo + 8.0)
                    + torch.einsum("bd,bpcd->bpc", qs[:, h:], hi + 8.0))
            qsum = torch.sum(qs[:, :h], dim=1) + torch.sum(qs[:, h:], dim=1)
            dots = dots - 8.0 * qsum[:, None, None]
        else:
            dots = torch.einsum("bd,bpcd->bpc", qs, rows.to(torch.float32))
        wr = w[pr]                                          # [bs, P, C]
        live = ((wr != 0) & (pos[None, None, :] < lim[pr][:, :, None])
                & known[b0:b0 + step, :, None])
        out[b0:b0 + step] = torch.where(live, dots * wr, INVALID)
    return out


def ivf_probe_scores_ref(q, probe, vecs, recip, nblocks=None) -> torch.Tensor:
    """Plain version of the bf16 / f32 probe kernel: [B, P, C] f32."""
    return _probe_ref("f32" if vecs.dtype == torch.float32 else "bf16",
                      q, probe, vecs, recip, nblocks)


def ivf_probe_scores_int8_ref(q, probe, codes, factor, nblocks=None) -> torch.Tensor:
    """Plain version of the int8 probe kernel: [B, P, C] f32."""
    return _probe_ref("int8", q, probe, codes, factor, nblocks)


def ivf_probe_scores_int4_ref(q, probe, codes, factor, nblocks=None) -> torch.Tensor:
    """Plain version of the int4 probe kernel: [B, P, C] f32."""
    return _probe_ref("int4", q, probe, codes, factor, nblocks)


# -- wrappers -----------------------------------------------------------------


def ivf_probe_scores(
    q: torch.Tensor,        # [B, D] f32, L2-normalized (cosine) or raw (dot)
    probe: torch.Tensor,    # [B, P] list ids (duplicates allowed)
    vecs: torch.Tensor,     # [L, C, D] bf16 or f32
    recip: torch.Tensor,    # [L, C] f32 weight plane from make_recip (0 = invalid)
    nblocks: Optional[torch.Tensor] = None,  # [L] occupied RB-row blocks; None = all
) -> torch.Tensor:
    """[B, P, C] f32 scores (invalid cells -1e9). CUDA tensors run the kernel."""
    if vecs.device.type == "cpu":
        return ivf_probe_scores_ref(q, probe, vecs, recip, nblocks)
    if vecs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ivf_probe: storage dtype {vecs.dtype} has no kernel")
    return _launch("f32" if vecs.dtype == torch.float32 else "bf16",
                   q, probe, vecs, recip, nblocks)


def ivf_probe_scores_int8(q, probe, codes, factor, nblocks=None) -> torch.Tensor:
    """The same over int8 codes [L, C, D]; ``factor`` folds the per-row scale
    and the cosine norm division (0 = invalid)."""
    if codes.device.type == "cpu":
        return ivf_probe_scores_int8_ref(q, probe, codes, factor, nblocks)
    return _launch("int8", q, probe, codes, factor, nblocks)


def ivf_probe_scores_int4(q, probe, codes, factor, nblocks=None) -> torch.Tensor:
    """The same over packed int4 codes [L, C, D/2] (int8-typed, split-plane).
    ``nblocks`` stays in 64-row units (the reference's TPU kernel fetched
    128-row blocks; rows past the high-water mark have factor 0, so the
    scores are the same)."""
    if codes.device.type == "cpu":
        return ivf_probe_scores_int4_ref(q, probe, codes, factor, nblocks)
    return _launch("int4", q, probe, codes, factor, nblocks)


# -- planes and selection -------------------------------------------------------


def nblocks_from_counts(counts, device=None) -> torch.Tensor:
    """Per-list occupied RB-row blocks from per-list row counts (high-water
    marks): ceil(counts / RB), int32."""
    c = torch.as_tensor(counts, dtype=torch.int64)
    return ((c + RB - 1) // RB).to(dtype=torch.int32, device=device)


def make_recip(norms: torch.Tensor, valid: torch.Tensor,
               metric: str = "cosine") -> torch.Tensor:
    """[L, C] norms + valid -> [L, C] score-weight plane: 1/|v| for cosine,
    1.0 for dot; 0 marks an invalid cell."""
    if metric == "cosine":
        r = 1.0 / torch.clamp(norms.to(torch.float32), min=1e-12)
    else:
        r = torch.ones_like(norms, dtype=torch.float32)
    return torch.where(valid, r, 0.0)


def make_factor(scales: torch.Tensor, norms: torch.Tensor, valid: torch.Tensor,
                metric: str = "cosine") -> torch.Tensor:
    """[L, C] dequant scales + norms + valid -> [L, C] factor plane for the
    code probes (scale / |v| for cosine, scale for dot; 0 = invalid)."""
    f = scales.to(torch.float32)
    if metric == "cosine":
        f = f / torch.clamp(norms.to(torch.float32), min=1e-12)
    return torch.where(valid, f, 0.0)


def _pad_k(vals: torch.Tensor, slots: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    got = vals.shape[1]
    if got >= k:
        return vals, slots
    vals = torch.nn.functional.pad(vals, (0, k - got), value=NEG_INF)
    slots = torch.nn.functional.pad(slots, (0, k - got), value=0)
    return vals, slots


def finalize_probe_topk(
    qp: torch.Tensor,        # [B, D] prepared queries
    probe: torch.Tensor,     # [B, P] probed list ids
    scores: torch.Tensor,    # [B, P, C] stage-2 scores (invalid <= -1e9)
    k: int,
    metric: str,
    cell_mask: Optional[torch.Tensor] = None,   # [L, C] bool filter
    rescore: int = 0,
    vecs: Optional[torch.Tensor] = None,        # [L, C, D] rescore shadow
    weight_fn: Optional[Callable] = None,       # (rl, rp) -> [B, R] f32 weight (0 = invalid)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared stage-2 selection: slot mapping (slot = list * C + pos), the
    filter-mask fold, an optional exact rescore of the top candidates, the
    final top-k and padding. Returns (vals [B, k] f32, slots [B, k] int64).

    Sentinels: -1e9 from scoring, -inf after the mask and validity folds,
    ``rv > -1e8`` as the rescore guard. Cosine scores clamp to 1.0."""
    b, p, c = scores.shape
    probe = probe.to(torch.int64)
    pos = torch.arange(c, device=scores.device)
    gslot = (probe[:, :, None] * c + pos[None, None, :]).reshape(b, p * c)
    flat = scores.reshape(b, p * c)
    if cell_mask is not None:
        allowed = cell_mask[probe].reshape(b, p * c)
        flat = torch.where(allowed, flat, NEG_INF)

    if rescore and vecs is not None:
        r = min(rescore, p * c)
        rv, ridx = torch.topk(flat, r, dim=1)
        rslot = torch.gather(gslot, 1, ridx)                  # [B, R]
        rl, rp = rslot // c, rslot % c
        cand = vecs[rl, rp].to(torch.float32)                 # [B, R, D]
        w = weight_fn(rl, rp)
        qc = qp.to(vecs.dtype).to(torch.float32)
        exact = torch.bmm(cand, qc[:, :, None])[:, :, 0] * w
        if metric == "cosine":
            exact = torch.clamp(exact, max=1.0)
        # rv > -1e8 drops masked (-inf) and invalid (-1e9) candidates; w > 0
        # drops cells deleted after the candidate scores were built
        exact = torch.where((rv > -1e8) & (w > 0), exact, NEG_INF)
        kk = min(k, r)
        vals, idx = torch.topk(exact, kk, dim=1)
        slots = torch.gather(rslot, 1, idx)
    else:
        kk = min(k, p * c)
        vals, idx = torch.topk(flat, kk, dim=1)
        if metric == "cosine":
            vals = torch.clamp(vals, max=1.0)
        vals = torch.where(vals > -1e8, vals, NEG_INF)
        slots = torch.gather(gslot, 1, idx)
    return _pad_k(vals, slots, k)


def _probe_lists(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                 metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prepared queries, [B, P] int32 top-nprobe lists by centroid dot)."""
    qp = prepare_queries(queries, metric)
    cq = qp @ centroids.to(torch.float32).T                      # [B, L] f32
    _, probe = torch.topk(cq, min(nprobe, centroids.shape[0]), dim=1)
    return qp, probe.to(torch.int32)


def ivf_topk(
    queries: torch.Tensor,     # [B, D] f32 raw
    centroids: torch.Tensor,   # [L, D] f32 (unit-norm for cosine/dot)
    vecs: torch.Tensor,        # [L, C, D] storage dtype
    recip: torch.Tensor,       # [L, C] f32 weight plane
    k: int,
    nprobe: int,
    metric: str = "cosine",
    cell_mask: Optional[torch.Tensor] = None,   # [L, C] bool (True = allowed)
    nblocks: Optional[torch.Tensor] = None,     # [L] occupied RB-row blocks
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, slots) of the bf16 / f32 IVF probe (reference
    ``pallas_ivf_topk``). A filter mask folds into the selection after the
    probe: 1 byte per scored cell."""
    qp, probe = _probe_lists(queries, centroids, nprobe, metric)
    scores = ivf_probe_scores(qp, probe, vecs, recip, nblocks=nblocks)
    return finalize_probe_topk(qp, probe, scores, k, metric, cell_mask=cell_mask)


def _codes_topk(probe_fn, queries, centroids, codes, factor, k, nprobe, metric,
                rescore, vecs, recip, cell_mask, nblocks):
    qp, probe = _probe_lists(queries, centroids, nprobe, metric)
    scores = probe_fn(qp, probe, codes, factor, nblocks=nblocks)
    return finalize_probe_topk(
        qp, probe, scores, k, metric, cell_mask=cell_mask, rescore=rescore, vecs=vecs,
        weight_fn=None if vecs is None else (lambda rl, rp: recip[rl, rp]))


def ivf_topk_int8(queries, centroids, codes, factor, k: int, nprobe: int,
                  metric: str = "cosine", rescore: int = 0,
                  vecs: Optional[torch.Tensor] = None,    # [L, C, D] bf16 shadow
                  recip: Optional[torch.Tensor] = None,   # [L, C] f32 (rescore)
                  cell_mask: Optional[torch.Tensor] = None,
                  nblocks: Optional[torch.Tensor] = None):
    """(vals, slots) over int8 lists (reference ``pallas_ivf_topk_int8``):
    with ``rescore > 0`` and a bf16 shadow the top ``rescore`` candidates are
    rescored exactly."""
    return _codes_topk(ivf_probe_scores_int8, queries, centroids, codes, factor, k,
                       nprobe, metric, rescore, vecs, recip, cell_mask, nblocks)


def ivf_topk_int4(queries, centroids, codes, factor, k: int, nprobe: int,
                  metric: str = "cosine", rescore: int = 0,
                  vecs: Optional[torch.Tensor] = None,
                  recip: Optional[torch.Tensor] = None,
                  cell_mask: Optional[torch.Tensor] = None,
                  nblocks: Optional[torch.Tensor] = None):
    """(vals, slots) over packed int4 lists (reference ``pallas_ivf_topk_int4``)."""
    return _codes_topk(ivf_probe_scores_int4, queries, centroids, codes, factor, k,
                       nprobe, metric, rescore, vecs, recip, cell_mask, nblocks)

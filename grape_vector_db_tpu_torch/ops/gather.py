"""Candidate gather-dot: ``dots[b, c] = q_b . vectors[ids[b, c]]``.

PyTorch counterpart of ``grape_vector_db_tpu/ops/gather_pallas.py``, the
scoring step of graph search: the beam scores ``expand * degree`` candidate
rows a query an iteration (and its entry points once), and the NN-descent
build scores each node's candidate list. The query is rounded to the storage
type before the product (bf16 q x bf16 row, or f32 x f32) and the sum is
taken in f32; an id outside ``[0, N)`` is clamped into it, as the Pallas
kernel clamps (the reference's XLA route wraps -1 instead; the graph path
never passes such an id).

On a CUDA tensor ``gather_dots`` launches one of two hand-written routes in
``csrc/gather.cu`` (they replace the Pallas ``_gather_kernel`` of
``ops/gather_pallas.py``) or raises, and adds one to
``LAUNCHES["gather_dots"]`` per call; on a CPU tensor the plain version
``gather_dots_ref`` runs. Every ``impl`` of the reference's signature
(``"xla"``, ``"pallas"``, ``"pallas_interpret"``) takes that rule.
``gather_route`` picks the route from B, C and the storage type:

- ``"pairs"``: a thread block scores 32 candidates of one query and reads
  each pair's row; one launch. It serves f32 storage and calls under
  ``GROUPED_MIN_PAIRS`` pairs (the beam's 128 x 256 and the entry step's
  128 x 64 name ~1.4 and ~2.3 pairs a distinct row: too few to pay for
  grouping).
- ``"grouped"`` (bf16 storage, at least ``GROUPED_MIN_PAIRS`` pairs: the
  NN-descent build's 2048 x 576): ``group_pairs`` keeps the first copy of
  each (query, row) pair of a candidate list and sorts the first copies by
  (query group, row); q is rounded to bf16 and zero-padded to whole 64-dim
  slices; a persistent kernel walks D slice by slice with the slice of the
  query group's plane in shared memory, so a pair's query comes from shared
  memory and the pairs of one row sit side by side; a last launch copies
  each first copy's dot to its repeats. It adds one to
  ``LAUNCHES["gather_dots_grouped"]`` as well.

Neither route materializes the ``[B, C, D]`` block of candidate rows that
the gather-then-product of the plain version makes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from grape_vector_db_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "reset_launch_counts", "build_kernels", "gather_dots",
           "gather_dots_ref", "gather_route", "group_pairs", "group_pairs_ref",
           "pallas_gather_supported", "GROUPED_MIN_PAIRS", "GROUP_QUERIES",
           "MAX_DEDUP_COLUMNS"]

#: Kernel launches since the last reset (CUDA tensors only): "gather_dots"
#: counts every call that launched a kernel, "gather_dots_grouped" those that
#: took the grouped route, "gather_group" the grouping passes (four small
#: launches and a memset each).
LAUNCHES: Dict[str, int] = {"gather_dots": 0, "gather_dots_grouped": 0, "gather_group": 0}

#: Queries whose 64-dim slice the grouped kernel holds in shared memory at
#: once (two buffers of 512 x 128 bytes); a larger batch is cut into query
#: groups, and the pairs sort by (query group, row).
GROUP_QUERIES = 512
#: The grouped route takes bf16 calls with at least this many pairs, the
#: pairs route the rest. Measured crossover (chip_smoke.py on an NVIDIA H100
#: 80GB HBM3, 700 W: both routes in turns over sub-batches of a build chunk
#: of its 131,072-row graph, C = 576, D = 768): the two take about the same
#: time at 442,368 pairs (B = 768); the grouped route is 11-13% faster at
#: 589,824 and 1.5x at 1,179,648, the pairs route ~1.2-2.8x faster at 294,912
#: (PERF.md, B11).
GROUPED_MIN_PAIRS = 1 << 19
#: Longest candidate list the card's grouping pass dedups (its hash table of
#: 2C slots fits 32 KB of shared memory); longer lists keep every copy.
MAX_DEDUP_COLUMNS = 2048
# Width of one slice of the grouped kernel; q' is zero-padded to a multiple.
_SLICE = 64

_IMPLS = ("xla", "pallas", "pallas_interpret")
_FMT = {torch.bfloat16: 0, torch.float32: 1}
# Largest staged query the kernel takes (D floats in 48 KB of shared memory).
_MAX_DIM = 12288
# Elements of the [rows, C, D] f32 candidate block one step of the plain
# version holds.
_REF_CHUNK_ELEMS = 1 << 26


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.gvdb_gather_dots.restype = ctypes.c_int
    lib.gvdb_gather_dots.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.gvdb_gather_dots_grouped.restype = ctypes.c_int
    lib.gvdb_gather_dots_grouped.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.gvdb_gather_group.restype = ctypes.c_int
    lib.gvdb_gather_group.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def build_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/gather.cu``."""
    return _build.load("gather", _bind)


def pallas_gather_supported(dim: int, dtype) -> bool:
    """True: the kernel takes any width and both storage types. (The
    reference answers False because its TPU compiler cannot copy a single
    row; a Hopper thread block reads single rows as they are.)"""
    del dim, dtype
    return True


def gather_dots_ref(q: torch.Tensor, vectors: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: clamp the ids into [0, N), gather the
    rows, and take the f32 product with q rounded to the storage type
    (products of bf16 values are exact in f32), a few queries at a time."""
    b, c = ids.shape
    d = q.shape[1]
    qc = q.to(vectors.dtype).to(torch.float32)
    idx = torch.clamp(ids.long(), 0, vectors.shape[0] - 1)
    out = torch.empty((b, c), dtype=torch.float32, device=vectors.device)
    step = max(1, _REF_CHUNK_ELEMS // max(c * d, 1))
    for off in range(0, b, step):
        rows = vectors[idx[off:off + step]].to(torch.float32)          # [r, C, D]
        out[off:off + step] = torch.bmm(rows, qc[off:off + step, :, None])[:, :, 0]
    return out


def gather_route(b: int, c: int, d: int, dtype: torch.dtype) -> str:
    """The route a CUDA call takes: ``"grouped"`` for bf16 storage with at
    least ``GROUPED_MIN_PAIRS`` pairs (the NN-descent build's 2048 x 576),
    ``"pairs"`` otherwise (f32 storage; the beam's 128 x 256 and the entry
    step's 128 x 64). D does not enter: both routes' costs grow with D
    alike (measured at D = 768 only)."""
    del d
    return "grouped" if dtype == torch.bfloat16 and b * c >= GROUPED_MIN_PAIRS else "pairs"


def group_pairs_ref(ids: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the grouping step. For ids [B, C] and rows
    ``clamp(ids, 0, n - 1)``: ``rep`` [B, C] int32, the first column of each
    query's list naming the same row (a repeated pair has its first copy's
    dot); ``order`` [B * C] int32, the flat indices ``b * C + c`` of the first
    copies in a stable order by (query group ``b // GROUP_QUERIES``, row),
    then -1; ``totals`` int32 [ceil(B / GROUP_QUERIES)], the first copies of
    each query group."""
    b, c = ids.shape
    groups = -(-b // GROUP_QUERIES)
    rows = torch.clamp(ids, 0, n - 1)
    srt, idx = torch.sort(rows, dim=1, stable=True)
    start = torch.ones_like(srt, dtype=torch.bool)
    start[:, 1:] = srt[:, 1:] != srt[:, :-1]
    cols = torch.arange(c, device=ids.device).expand(b, c)
    run_start = torch.where(start, cols, torch.zeros_like(cols)).cummax(dim=1).values
    rep = torch.empty_like(rows)
    rep.scatter_(1, idx, torch.gather(idx, 1, run_start).to(rows.dtype))
    first = (rep == cols).reshape(-1)
    flat = torch.nonzero(first).reshape(-1)
    group = torch.arange(b, device=ids.device, dtype=torch.int64) // GROUP_QUERIES
    key = (rows.to(torch.int64) + (group * n)[:, None]).reshape(-1)
    order = torch.full((b * c,), -1, dtype=torch.int32, device=ids.device)
    order[:flat.numel()] = flat[torch.argsort(key[flat], stable=True)].to(torch.int32)
    totals = torch.bincount(group.repeat_interleave(c)[flat], minlength=groups)
    return order, rep.to(torch.int32), totals.to(torch.int32)


def group_pairs(ids: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouping step of the grouped route: ``(order, rep, totals)`` as
    ``group_pairs_ref`` defines them, with two freedoms on the card: the
    first copies of one (query group, row) key are contiguous in ``order``
    but in any order, and so are the keys within a query group (the groups
    come in order); and a list longer than ``MAX_DEDUP_COLUMNS`` keeps every
    copy (``rep[b, c] = c``). On a CUDA tensor the hand-written pass of
    ``csrc/gather.cu`` (per-query dedup through a hash table in shared memory
    with the counts, offsets, scatter: four launches and a memset, counted
    once in ``LAUNCHES["gather_group"]``) or raises; on a CPU tensor
    ``group_pairs_ref``."""
    if ids.device.type == "cpu":
        return group_pairs_ref(ids, n)
    b, c = ids.shape
    if ids.dtype != torch.int32 or b * c >= 1 << 31:
        raise ValueError(f"group_pairs: ids must be int32 with fewer than 2^31 entries, "
                         f"got {ids.dtype} {tuple(ids.shape)}")
    groups = -(-b // GROUP_QUERIES)
    ic = ids.contiguous()
    rep = torch.empty((b, c), dtype=torch.int32, device=ids.device)
    order = torch.empty(b * c, dtype=torch.int32, device=ids.device)
    scratch = torch.empty(groups * n + 2 * groups, dtype=torch.int32, device=ids.device)
    lib = build_kernels()
    _raise_on(lib, lib.gvdb_gather_group(
        ids.device.index or 0, ic.data_ptr(), rep.data_ptr(), order.data_ptr(),
        scratch.data_ptr(), b, c, n, GROUP_QUERIES,
        torch.cuda.current_stream(ids.device).cuda_stream), "grouping")
    LAUNCHES["gather_group"] += 1
    return order, rep, scratch[groups * n + groups:]


def _sliced_queries(q: torch.Tensor) -> torch.Tensor:
    """q' for the grouped kernel: q rounded to bf16 and zero-padded to whole
    slices, [B, Dp] contiguous."""
    d = q.shape[1]
    qb = q.to(torch.bfloat16)
    if d % _SLICE:
        qb = torch.nn.functional.pad(qb, (0, _SLICE - d % _SLICE))
    return qb.contiguous()


def _check(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor) -> None:
    dev = vectors.device
    if dev.type != "cuda" or q.device != dev or ids.device != dev:
        raise ValueError("gather_dots: q, vectors and ids must lie on one CUDA device")
    if vectors.dtype not in _FMT:
        raise ValueError(f"gather_dots: vectors must be bfloat16 or float32, not {vectors.dtype}")
    if q.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"gather_dots: q must be float32 and ids int32, got {q.dtype} "
                         f"and {ids.dtype}")
    n, d = vectors.shape
    b, c = ids.shape
    if q.shape != (b, d) or n < 1 or d < 1 or d > _MAX_DIM:
        raise ValueError(f"gather_dots: shapes q {tuple(q.shape)}, vectors "
                         f"{tuple(vectors.shape)} and ids {tuple(ids.shape)} disagree, are "
                         f"empty, or D > {_MAX_DIM}")


def _raise_on(lib: ctypes.CDLL, rc: int, route: str) -> None:
    if rc != 0:
        raise RuntimeError(f"gather_dots {route} launch failed: "
                           f"{lib.gvdb_cuda_error_string(rc).decode()} ({rc})")


def _launch_pairs(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                  out: torch.Tensor) -> None:
    n, d = vectors.shape
    b, c = ids.shape
    qc, vc, ic = q.contiguous(), vectors.contiguous(), ids.contiguous()
    lib = build_kernels()
    dev = vectors.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.gvdb_gather_dots(_FMT[vectors.dtype], dev.index or 0, qc.data_ptr(),
                                        vc.data_ptr(), ic.data_ptr(), out.data_ptr(), b, c,
                                        n, d, stream), "pairs")


def _launch_grouped(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                    out: torch.Tensor) -> None:
    if vectors.dtype != torch.bfloat16:
        raise ValueError("gather_dots: the grouped route takes bf16 storage only")
    n, d = vectors.shape
    b, c = ids.shape
    lib = build_kernels()
    vc, ic = vectors.contiguous(), ids.contiguous()
    order, rep, totals = group_pairs(ic, n)
    qb = _sliced_queries(q)
    dev = vectors.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.gvdb_gather_dots_grouped(
        dev.index or 0, qb.data_ptr(), vc.data_ptr(), ic.data_ptr(), rep.data_ptr(),
        order.data_ptr(), totals.data_ptr(), out.data_ptr(), b, c, n, d, qb.shape[1],
        GROUP_QUERIES, stream), "grouped")
    LAUNCHES["gather_dots_grouped"] += 1


def gather_dots(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                impl: str = "xla", route: Optional[str] = None) -> torch.Tensor:
    """q [B, D] f32 (already ``prepare_queries``'d), vectors [N, D] bf16 or
    f32, ids [B, C] int32 -> dots [B, C] f32. CUDA tensors run a kernel (or
    raise): the one ``gather_route`` picks, or ``route`` (``"pairs"`` or
    ``"grouped"``) when given; CPU tensors the plain version."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown gather impl: {impl}")
    if route not in (None, "pairs", "grouped"):
        raise ValueError(f"unknown gather route: {route}")
    if vectors.device.type == "cpu":
        return gather_dots_ref(q, vectors, ids)
    _check(q, vectors, ids)
    b, c = ids.shape
    out = torch.empty((b, c), dtype=torch.float32, device=vectors.device)
    if b == 0 or c == 0:
        return out
    route = route or gather_route(b, c, vectors.shape[1], vectors.dtype)
    (_launch_grouped if route == "grouped" else _launch_pairs)(q, vectors, ids, out)
    LAUNCHES["gather_dots"] += 1
    return out

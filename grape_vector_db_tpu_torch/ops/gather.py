"""Candidate gather-dot: ``dots[b, c] = q_b . vectors[ids[b, c]]``.

PyTorch counterpart of ``grape_vector_db_tpu/ops/gather_pallas.py``, the
scoring step of graph search: the beam scores ``expand * degree`` candidate
rows a query an iteration (and its entry points once), and the NN-descent
build scores each node's candidate list. The query is rounded to the storage
type before the product (bf16 q x bf16 row, or f32 x f32) and the sum is
taken in f32; an id outside ``[0, N)`` is clamped into it, as the Pallas
kernel clamps (the reference's XLA route wraps -1 instead; the graph path
never passes such an id).

On a CUDA tensor ``gather_dots`` launches the hand-written kernel in
``csrc/gather.cu`` (it replaces the Pallas ``_gather_kernel`` of
``ops/gather_pallas.py``) or raises, and adds one to
``LAUNCHES["gather_dots"]`` per launch; on a CPU tensor the plain version
``gather_dots_ref`` runs. Every ``impl`` of the reference's signature
(``"xla"``, ``"pallas"``, ``"pallas_interpret"``) takes that rule: the
kernel never materializes the ``[B, C, D]`` block of candidate rows that
the gather-then-product of the plain version makes.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from grape_vector_db_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "reset_launch_counts", "build_kernels", "gather_dots",
           "gather_dots_ref", "pallas_gather_supported"]

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES: Dict[str, int] = {"gather_dots": 0}

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


def _launch(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
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
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    qc, vc, ic = q.contiguous(), vectors.contiguous(), ids.contiguous()
    lib = build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gvdb_gather_dots(_FMT[vectors.dtype], dev.index or 0, qc.data_ptr(),
                              vc.data_ptr(), ic.data_ptr(), out.data_ptr(), b, c, n, d, stream)
    if rc != 0:
        raise RuntimeError(f"gather_dots kernel launch failed: "
                           f"{lib.gvdb_cuda_error_string(rc).decode()} ({rc})")
    LAUNCHES["gather_dots"] += 1
    return out


def gather_dots(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                impl: str = "xla") -> torch.Tensor:
    """q [B, D] f32 (already ``prepare_queries``'d), vectors [N, D] bf16 or
    f32, ids [B, C] int32 -> dots [B, C] f32. CUDA tensors run the kernel
    (or raise); CPU tensors the plain version."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown gather impl: {impl}")
    if vectors.device.type == "cpu":
        return gather_dots_ref(q, vectors, ids)
    return _launch(q, vectors, ids)

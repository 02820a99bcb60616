"""Binary quantization: bit packing and the Hamming / asymmetric prescans.

PyTorch counterpart of ``grape_vector_db_tpu/ops/hamming.py`` and
``ops/hamming_pallas.py``. Each vector's signs pack into ``ceil(dim / 32)``
32-bit words (bit j of word w = coord ``w*32 + j`` > threshold). PyTorch's
``uint32`` supports few operations, so codes are **int32 tensors holding the
same bits** as the reference's uint32 codes (``codes.view(np.int32)`` of a
JAX array gives the port's codes, and back).

``hamming_scores`` has the reference's three routes:

- ``"mxu"`` (the default of ``BinaryDeviceIndex``): decode both sides to
  +-1 bf16 and take one f32-accumulated product; ``dot = D - 2 * hamming``
  is exact. A plain product outside any kernel, as the reference left it
  to XLA.
- ``"popcount"`` and ``"xla"``: the same integers as Sum_w popcount(q_w ^ c_w).
  On a CUDA tensor both launch the hand-written kernel in
  ``csrc/hamming.cu``, a b1 tensor-core product (popc(q ^ c) = popc q +
  popc c - 2 popc(q & c); it replaces the Pallas ``_kernel`` of
  ``ops/hamming_pallas.py``; the reference's XLA broadcast would allocate a
  ``[B, C, W]`` int32 plane, 3.2 GB a 262,144-row chunk at B=128, W=24); on
  a CPU tensor the plain version ``hamming_scores_ref`` runs.

``hamming_popcount`` launches the kernel or raises for a CUDA tensor and
adds one to ``LAUNCHES["hamming"]`` per launch. Selections are exact and
break ties on the lower slot, as the reference's ``lax.top_k`` does (and its
``approx_max_k``, which is exact off the TPU).

``asym_topk``, the asymmetric prescan, scores ``bf16(q_unit)`` against the
+-1 signs in f32 through ``asym_scores``: on a CUDA tensor the hand-written
kernel of ``csrc/asym.cu`` (bf16 tensor cores, the signs built in registers
from the packed words; it replaces no Pallas kernel: the reference left the
decode and product to XLA, which fuses them), which adds one to
``LAUNCHES["asym"]`` per launch or raises; on a CPU tensor the plain version
``asym_scores_ref`` (decode to a +-1 bf16 plane, one product).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from grape_vector_db_tpu_torch.ops import _build
from grape_vector_db_tpu_torch.ops.distance import _pad_k, chunked_topk, f32_dots

__all__ = ["LAUNCHES", "reset_launch_counts", "build_kernels", "INVALID_DIST",
           "build_asym_kernel", "words_per_vector", "pack_bits", "hamming_scores",
           "hamming_popcount", "hamming_scores_ref", "hamming_topk", "asym_scores",
           "asym_scores_ref", "asym_topk"]

#: Distance of an invalid row (sorts after every real distance).
INVALID_DIST = 2**30
NEG_INF = float("-inf")

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES: Dict[str, int] = {"hamming": 0, "asym": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- building and binding the CUDA kernel --------------------------------------

#: What the build did: library path, seconds, compiler log (ptxas -v).
BUILD_INFO: Dict[str, object] = _build.BUILD_INFO.setdefault("hamming", {})


def _bind(lib: ctypes.CDLL) -> None:
    lib.gvdb_hamming.restype = ctypes.c_int
    lib.gvdb_hamming.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def build_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/hamming.cu``."""
    return _build.load("hamming", _bind)


def _bind_asym(lib: ctypes.CDLL) -> None:
    lib.gvdb_asym.restype = ctypes.c_int
    lib.gvdb_asym.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])


def build_asym_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/asym.cu``."""
    return _build.load("asym", _bind_asym)


# -- packing ------------------------------------------------------------------


def words_per_vector(dim: int) -> int:
    return (dim + 31) // 32


def pack_bits(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Binarize + pack: [N, D] float -> [N, W] int32 words.

    Coordinates beyond D (padding to a multiple of 32) pack as 0 bits on
    both sides, so they never add to a Hamming distance. Words are summed in
    int64 and wrapped to int32 (bit 31 set gives a negative word), so the
    result is bit-equal to the reference's uint32 codes."""
    n, d = x.shape
    w = words_per_vector(d)
    bits = (x > threshold).to(torch.int64)
    if w * 32 != d:
        bits = torch.nn.functional.pad(bits, (0, w * 32 - d))
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = torch.sum(bits.view(n, w, 32) << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _unpack_signs(c: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 -> [N, W*32] bfloat16 in {-1, +1} (bit b -> 2b - 1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=c.device)
    bits = (c[:, :, None] >> shifts) & 1
    return (2 * bits - 1).to(torch.bfloat16).reshape(c.shape[0], -1)


# -- the popcount scan: kernel, plain version, wrapper ---------------------------

# Elements of the [B, rows, W] xor plane one step of the plain version holds.
_REF_CHUNK_ELEMS = 1 << 26


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word (SWAR in int64: no overflow)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_scores_ref(qcodes: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of the popcount kernel: [B, W] x [C, W] int32 -> [B, C]
    int32 of Sum_w popcount(q_w ^ c_w), a few corpus rows at a time."""
    b, w = qcodes.shape
    c = codes.shape[0]
    out = torch.empty((b, c), dtype=torch.int32, device=codes.device)
    step = max(1, _REF_CHUNK_ELEMS // max(b * w, 1))
    for off in range(0, c, step):
        x = torch.bitwise_xor(qcodes[:, None, :], codes[None, off:off + step, :])
        out[:, off:off + step] = torch.sum(_popcount32(x), dim=2)
    return out


def _launch(qcodes: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    dev = codes.device
    if dev.type != "cuda" or qcodes.device != dev:
        raise ValueError("hamming: qcodes and codes must lie on one CUDA device")
    if qcodes.dtype != torch.int32 or codes.dtype != torch.int32:
        raise ValueError(f"hamming: codes must be int32 words, got {qcodes.dtype} "
                         f"and {codes.dtype}")
    b, w = qcodes.shape
    c = codes.shape[0]
    if codes.ndim != 2 or codes.shape[1] != w or b < 1 or c < 1 or w < 1:
        raise ValueError(f"hamming: shapes qcodes {tuple(qcodes.shape)} and codes "
                         f"{tuple(codes.shape)} disagree or are empty")
    qc = qcodes.contiguous()
    cc = codes.contiguous()
    lib = build_kernels()
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gvdb_hamming(dev.index or 0, qc.data_ptr(), cc.data_ptr(), out.data_ptr(),
                          b, c, w, stream)
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: "
                           f"{lib.gvdb_cuda_error_string(rc).decode()} ({rc})")
    LAUNCHES["hamming"] += 1
    return out


def hamming_popcount(qcodes: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, W] x [C, W] int32 -> [B, C] int32 Hamming distances. CUDA tensors
    run the kernel (or raise); CPU tensors the plain version."""
    if codes.device.type == "cpu":
        return hamming_scores_ref(qcodes, codes)
    return _launch(qcodes, codes)


def hamming_scores(qcodes: torch.Tensor, codes: torch.Tensor,
                   impl: str = "mxu") -> torch.Tensor:
    """Hamming distances: [B, W] x [C, W] int32 -> [B, C] int32."""
    if impl == "mxu":
        dot = f32_dots(_unpack_signs(qcodes), _unpack_signs(codes))
        d_tot = float(codes.shape[1] * 32)
        return ((d_tot - dot) * 0.5).to(torch.int32)
    if impl in ("popcount", "xla"):
        return hamming_popcount(qcodes, codes)
    raise ValueError(f"unknown hamming impl {impl!r}: use 'mxu', 'popcount' or 'xla'")


# -- selections ---------------------------------------------------------------


def _smallest_first(d: torch.Tensor, slots: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (distance, slot) pairs of each row, ascending, ties on
    the lower slot first: one exact top-k on the int64 key d << 32 | slot."""
    key = (d.to(torch.int64) << 32) | slots.to(torch.int64)
    top, _ = torch.topk(key, k, dim=1, largest=False)
    return (top >> 32).to(torch.int32), top & 0xFFFFFFFF


def hamming_topk(
    qcodes: torch.Tensor,   # [B, W] int32
    codes: torch.Tensor,    # [N, W] int32 (capacity-padded)
    valid: torch.Tensor,    # [N] bool
    k: int,
    chunk: int = 16384,
    impl: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k *smallest* Hamming distance over the packed corpus, a chunk at a
    time, then a merge. Returns (distances [B, k] int32, slots [B, k]
    int64); invalid rows have distance ``INVALID_DIST``. The order is
    (distance, slot) ascending, so any chunking gives the same answer."""
    def score(lo, hi):
        d = hamming_scores(qcodes, codes[lo:hi], impl=impl)
        return torch.where(valid[None, lo:hi], d, INVALID_DIST)

    dv, sv = chunked_topk(score, codes.shape[0], chunk, k, select=_smallest_first)
    return _pad_k(dv, sv, k, INVALID_DIST)


# -- the asymmetric scan: kernel, plain version, wrapper ----------------------------


def asym_scores_ref(qb: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the asym kernel: [B, D] bf16 x [C, W] int32 words ->
    [B, C] f32 of ``dot(qb, sign(x))`` (the codes decoded to a +-1 bf16
    plane, one f32-accumulated product); -inf where ``valid`` [C] is false."""
    # padding coords decode to -1; q has no lanes there
    dots = f32_dots(qb, _unpack_signs(codes)[:, :qb.shape[1]])
    return torch.where(valid[None, :], dots, NEG_INF)


def _launch_asym(qb: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    dev = codes.device
    if dev.type != "cuda" or qb.device != dev or valid.device != dev:
        raise ValueError("asym: the query, codes and valid must lie on one CUDA device")
    if qb.dtype != torch.bfloat16 or codes.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"asym: needs a bf16 query, int32 codes and a bool mask, got "
                         f"{qb.dtype}, {codes.dtype} and {valid.dtype}")
    b, d = qb.shape
    c = codes.shape[0]
    if (codes.ndim != 2 or codes.shape[1] != words_per_vector(d) or valid.shape != (c,)
            or b < 1 or c < 1 or d < 1):
        raise ValueError(f"asym: shapes query {tuple(qb.shape)}, codes {tuple(codes.shape)} "
                         f"and valid {tuple(valid.shape)} disagree or are empty")
    qc, cc, vc = qb.contiguous(), codes.contiguous(), valid.contiguous()
    lib = build_asym_kernel()
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gvdb_asym(dev.index or 0, qc.data_ptr(), cc.data_ptr(), vc.data_ptr(),
                       out.data_ptr(), b, c, d, stream)
    if rc != 0:
        raise RuntimeError(f"asym kernel launch failed: "
                           f"{lib.gvdb_cuda_error_string(rc).decode()} ({rc})")
    LAUNCHES["asym"] += 1
    return out


def asym_scores(qb: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, D] bf16 x [C, W] int32 words -> [B, C] f32 ``dot(qb, sign(x))``,
    -inf where ``valid`` is false. CUDA tensors run the kernel (or raise);
    CPU tensors the plain version."""
    if codes.device.type == "cpu":
        return asym_scores_ref(qb, codes, valid)
    return _launch_asym(qb, codes, valid)


def asym_topk(
    queries: torch.Tensor,  # [B, D] f32 raw (normalized here)
    codes: torch.Tensor,    # [N, W] int32 (capacity-padded)
    valid: torch.Tensor,    # [N] bool
    k: int,
    chunk: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric binary prescan: top-k LARGEST ``dot(bf16(q_unit), sign(x))``
    in f32, a chunk at a time, then a merge. Returns (scores [B, k] f32
    descending, slots [B, k] int64); invalid rows score -inf."""
    qf = queries.to(torch.float32)
    qn = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=1, keepdim=True), min=1e-12)
    qb = qn.to(torch.bfloat16)
    v, s = chunked_topk(lambda lo, hi: asym_scores(qb, codes[lo:hi], valid[lo:hi]),
                        codes.shape[0], chunk, k)
    return _pad_k(v, s, k)

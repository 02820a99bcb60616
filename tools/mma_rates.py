"""Tensor-core issue rates of the packed-bit Hamming scan's two routes.

Run on a machine with an NVIDIA Hopper card and the CUDA toolkit:

    python3 tools/mma_rates.py

It builds ``tools/mma_rates.cu`` with the port's builder (into its
gitignored ``_build/``), times back-to-back ``mma.sync`` instructions on every SM with
CUDA events, and prints the card's name and power limit, then one JSON
object: for each route the instructions a second, the bit (or byte) pairs a
second, and the floor those rates set at the binary index's scan chunk,
q [128, 24] x codes [262,144, 24] words:

- ``b1``: ``m16n8k256`` b1 ``.and.popc``; the words are the fragments, so
  the scan needs B * C * W / 1024 instructions;
- ``s8``: ``m16n8k32`` s8 on +-1 bytes; B * C * W / 128 instructions, plus
  the expansion of every word into 32 bytes (not counted here).

No published figure gives Hopper's b1 rate, so ``chip_smoke.py`` takes the
b1 floor it reports for the Hamming kernel from ``b1_rate()``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "tools", "mma_rates.cu")
ROUTES = {"b1": (0, 16 * 8 * 256), "s8": (1, 16 * 8 * 32)}   # code, pairs an instruction
MAIN_SHAPE = (128, 262_144, 24)                               # B, C, W


def _bind(lib: ctypes.CDLL) -> None:
    lib.gvdb_mma_rate.restype = ctypes.c_int
    lib.gvdb_mma_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _library() -> ctypes.CDLL:
    sys.path.insert(0, REPO)
    from grape_vector_db_tpu_torch.ops import _build

    return _build.load("mma_rates", _bind, SRC)


def rate(route: str, iters: int = 4096, blocks_per_sm: int = 8) -> float:
    """Instructions a second the card issues for ``route`` ("b1" or "s8"),
    from the best of three timed launches after a warm-up."""
    lib = _library()
    code, _ = ROUTES[route]
    blocks = blocks_per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.gvdb_mma_rate(code, blocks, iters, out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"mma rate probe launch failed ({rc})")

    launch()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return blocks * 8 * 4 * iters / best


def b1_rate() -> float:
    return rate("b1")


def floors(b: int, c: int, w: int, rates: dict) -> dict:
    """Milliseconds each route's instructions take at those rates."""
    need = {r: b * c * w * 32 / ROUTES[r][1] for r in rates}
    return {r: need[r] / rates[r] * 1e3 for r in rates}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mma_rates: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    rates = {r: rate(r) for r in ROUTES}
    b, c, w = MAIN_SHAPE
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "instructions_per_s": rates,
        "pairs_per_s": {r: rates[r] * ROUTES[r][1] for r in rates},
        "floor_ms_at": {"shape": [b, c, w], **floors(b, c, w, rates)},
    }))


if __name__ == "__main__":
    main()

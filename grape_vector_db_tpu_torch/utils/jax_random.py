"""JAX's default random stream, reproduced in numpy for the bf16 normal.

The device embedder's projection is ``jax.random.normal(PRNGKey(seed),
(buckets, dim), bfloat16)`` in the JAX package
(``services/device_embedder.py``). A store embedded there and queried here
must live in the same vector space, so the port draws the same plane bit for
bit, without JAX:

- **Key.** ``PRNGKey(seed)`` with 64-bit mode off (the JAX package's setting)
  is ``[0, seed mod 2**32]`` as uint32.
- **Bits.** With ``jax_threefry_partitionable`` on (the default), element
  ``i`` of the row-major flat index draws one Threefry-2x32 block (20
  rounds) over the counter ``(i >> 32, i & 0xFFFFFFFF)`` and keeps
  ``uint8(bits1 ^ bits2)``: bf16 has 7 mantissa bits, under 8, so the
  uniform sampler takes 8 random bits.
- **Transform.** The top 7 of those bits become the mantissa of a bf16 in
  [1, 2); minus 1, times ``1 - lo`` (2 in bf16), plus ``lo`` (the bf16 next
  to -1 towards 0), at least ``lo``; then ``sqrt(2) * erfinv(u)``. Each op
  rounds to bf16 as XLA does; erfinv is taken in f64 and rounded to f32,
  then to bf16.

An element is therefore one of 128 values, indexed by ``byte >> 1``: the
table is built once, and a plane is its bytes looked up in it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["prng_key", "threefry2x32", "random_bits8", "normal_bf16_table", "normal_bf16"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_MASK = 0xFFFFFFFF
_CHUNK = 1 << 20          # counters hashed at a time


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two uint32 words, 64-bit mode off."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32, 20 rounds, over uint32 counter words ``(x1, x2)``
    (``jax._src.prng._threefry2x32_lowering``). uint32 arithmetic wraps."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = x1.astype(np.uint32) + ks[0]
    b = x2.astype(np.uint32) + ks[1]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            a += b
            b = _rotl(b, r)
            b ^= a
        a += ks[(step + 1) % 3]
        b += ks[(step + 2) % 3]
        b += np.uint32(step + 1)
    return a, b


def random_bits8(key: np.ndarray, flat_index: np.ndarray) -> np.ndarray:
    """The uint8 that ``jax.random.bits(key, shape, uint8)`` holds at each
    row-major flat index (uint64)."""
    i = np.asarray(flat_index, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(_MASK)).astype(np.uint32)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).astype(np.uint8)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even, as XLA does) and back to f64."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def normal_bf16_table() -> torch.Tensor:
    """The 128 bf16 values of ``jax.random.normal(..., bfloat16)``, indexed by
    the random byte shifted right by one."""
    one = torch.tensor(1.0, dtype=torch.float64)
    lo = _bf16(torch.nextafter(torch.tensor(-1.0, dtype=torch.bfloat16),
                               torch.tensor(0.0, dtype=torch.bfloat16)).to(torch.float64))
    span = _bf16(one - lo)
    mant = torch.arange(128, dtype=torch.int32) | 0x3F80        # bf16 bits of [1, 2)
    floats = torch.from_numpy(mant.numpy().astype(np.uint16).view(np.int16)).view(
        torch.bfloat16).to(torch.float64)
    u = _bf16(_bf16(_bf16(floats - one) * span) + lo)
    u = torch.maximum(lo, u)
    e = torch.erfinv(u).to(torch.float32).to(torch.bfloat16).to(torch.float64)
    return _bf16(_bf16(torch.tensor(math.sqrt(2.0), dtype=torch.float64)) * e).to(torch.bfloat16)


def normal_bf16(seed: int, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape, bfloat16)`` as a CPU bf16
    tensor, hashed in chunks of 2**20 counters."""
    n = math.prod(shape)
    key = prng_key(seed)
    table = normal_bf16_table().view(torch.int16).numpy()
    out = np.empty(n, dtype=np.int16)
    for start in range(0, n, _CHUNK):
        idx = np.arange(start, min(start + _CHUNK, n), dtype=np.uint64)
        out[start:start + len(idx)] = table[random_bits8(key, idx) >> 1]
    return torch.from_numpy(out).view(torch.bfloat16).reshape(tuple(shape))

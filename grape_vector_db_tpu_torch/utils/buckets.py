"""Static-shape bucketing helpers.

XLA traces/compiles one program per distinct shape. A dynamic corpus in a
static-shape world (SURVEY.md §7.3) is handled by padding every host->device
batch to a small set of bucket sizes (powers of ``factor`` above ``base``) so the
jit cache stays tiny while shapes remain static.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["next_bucket", "pad_rows", "pad_to"]


def next_bucket(n: int, base: int = 8, factor: int = 2) -> int:
    """Smallest bucket (base * factor^i) >= n."""
    if n <= 0:
        return base
    b = base
    while b < n:
        b *= factor
    return b


# Sentinel slot index for padded scatter rows. MUST be out-of-range-high:
# JAX scatter wraps NEGATIVE indices (numpy semantics) BEFORE mode="drop"'s
# bounds check, so a -1 fill silently writes the array's LAST row (phantom
# valid zero-vectors that eat result slots).
PAD_SLOT = 1 << 30


def pad_rows(x: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad a [n, ...] array with fill rows up to ``rows``."""
    n = x.shape[0]
    if n == rows:
        return x
    if n > rows:
        raise ValueError(f"cannot pad {n} rows down to {rows}")
    pad_shape = (rows - n,) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)], axis=0)


def pad_to(x: np.ndarray, rows: int, fill) -> np.ndarray:
    return pad_rows(np.asarray(x), rows, fill)

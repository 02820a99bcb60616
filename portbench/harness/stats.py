"""Order statistics of the metrics."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


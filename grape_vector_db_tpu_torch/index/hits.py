"""Search hits from read-back arrays, shared by every index kind.

A search reads back its top-k as two arrays, scores and slots (a flat
index's slot, an IVF index's cell); ``hits_from_arrays`` turns them into the
per-query ``(id, score)`` lists of ``VectorIndex.search_batch``, and
``merge_hits`` folds a second region's hits (IVF's overflow) into the rows
that have any.
"""

from __future__ import annotations

from operator import itemgetter
from typing import List, Optional, Sequence

import numpy as np

from grape_vector_db_tpu_torch.index.base import SearchHit

__all__ = ["hits_from_arrays", "merge_hits"]


def hits_from_arrays(vals: np.ndarray, slots: np.ndarray,
                     ids: Sequence[Optional[str]]) -> List[List[SearchHit]]:
    """Read-back top-k arrays -> per-row ``(id, score)`` lists, in their order.

    ``vals`` [B, k] scores, ``slots`` [B, k] integer positions into ``ids``
    (a flat index's ids by slot, an IVF index's by cell; ``None`` marks a
    free one). An entry whose score is not finite, or whose id is ``None``,
    is left out. The arrays are converted once and the ids read in one
    gather; only a batch holding such entries is filtered."""
    vals = np.asarray(vals)
    slots = np.asarray(slots)
    b, k = vals.shape
    if k == 0:
        return [[] for _ in range(b)]
    finite = np.isfinite(vals)
    if finite.all():
        flat, scores = slots.reshape(-1), vals.tolist()
        bounds = range(0, b * k + 1, k)
    else:
        # gather only the finite entries: a padded entry's slot may name no id
        flat, kept = slots[finite], vals[finite].tolist()
        bounds = [0, *np.cumsum(finite.sum(axis=1)).tolist()]
        scores = [kept[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    if len(flat) > 1:
        got = itemgetter(*flat.tolist())(ids)
    else:
        got = [ids[int(s)] for s in flat]   # itemgetter of one item returns it bare
    rows = [list(zip(got[lo:hi], row)) for lo, hi, row in zip(bounds, bounds[1:], scores)]
    if None in got:
        rows = [[h for h in row if h[0] is not None] for row in rows]
    return rows


def merge_hits(rows: List[List[SearchHit]], extra: Sequence[List[SearchHit]],
               k: int) -> int:
    """Merge each row's ``extra`` hits (an overflow region's) into ``rows``
    in place: by score, descending (a stable sort, so ties keep the main
    region's order first), each id once, at most ``k``. A row with no
    extra hits is left as it is: it is already sorted and holds each id
    once. Returns the number of rows merged."""
    merged = 0
    for r, more in enumerate(extra):
        if not more:
            continue
        hits = rows[r] + more
        hits.sort(key=lambda h: -h[1])
        seen = set()
        uniq = []
        for h in hits:
            if h[0] not in seen:
                seen.add(h[0])
                uniq.append(h)
        rows[r] = uniq[:k]
        merged += 1
    return merged

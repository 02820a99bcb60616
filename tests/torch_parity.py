"""Comparison rules shared by the PyTorch port's parity tests.

Top-k results compare as id sets with a near-tie guard: two engines that sum
in different orders may swap rows whose scores lie within the tolerance of
the k-th score, and nothing else. Values compare rank by rank.

A tolerance ``tol`` is absolute for scores of magnitude up to 1 and relative
above (``tol * max(1, |score|)``): dot and euclidean scores grow with the
dimension, and f32 sums lose digits in proportion.
"""

from __future__ import annotations

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    """numpy copy of a torch tensor or a JAX / numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype.is_floating_point:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _allowance(ref, tol: float):
    return tol * np.maximum(1.0, np.abs(np.nan_to_num(ref, posinf=0.0, neginf=0.0)))


def assert_close(vals, ref, tol: float) -> None:
    vals = np.asarray(vals, np.float64)
    ref = np.asarray(ref, np.float64)
    assert vals.shape == ref.shape, (vals.shape, ref.shape)
    np.testing.assert_array_equal(np.isneginf(vals), np.isneginf(ref))
    fin = np.isfinite(ref)
    bad = np.abs(vals[fin] - ref[fin]) > _allowance(ref[fin], tol)
    assert not bad.any(), (
        f"{bad.sum()} values differ by more than {tol} (scaled): "
        f"{vals[fin][bad][:5]} vs {ref[fin][bad][:5]}")


def assert_topk_match(vals, ids, ref_vals, ref_ids, tol: float) -> None:
    """[B, k] (vals, ids) against a reference (ref_vals, ref_ids)."""
    vals = to_np(vals).astype(np.float64)
    ref_vals = to_np(ref_vals).astype(np.float64)
    ids = to_np(ids).astype(np.int64)
    ref_ids = to_np(ref_ids).astype(np.int64)
    assert ids.shape == ref_ids.shape
    assert_close(vals, ref_vals, tol)
    for r in range(vals.shape[0]):
        fin = np.isfinite(vals[r])
        ref_fin = np.isfinite(ref_vals[r])
        got = dict(zip(ids[r][fin].tolist(), vals[r][fin].tolist()))
        want = dict(zip(ref_ids[r][ref_fin].tolist(), ref_vals[r][ref_fin].tolist()))
        assert len(got) == fin.sum(), f"row {r}: duplicate ids {ids[r]}"
        if not want:
            assert not got
            continue
        kth = min(want.values())
        for i in set(got) ^ set(want):
            v = got.get(i, want.get(i))
            assert abs(v - kth) <= _allowance(kth, tol), (
                f"row {r}: id {i} (score {v}) differs away from the k-th "
                f"score {kth}: {sorted(got)} vs {sorted(want)}")


def cell_map(index) -> dict:
    """An IVF index's cell -> id mapping (cell = list * list_cap + pos), read
    from the port's id table by cell in the form of the JAX index's dict."""
    return {c: i for c, i in enumerate(index._cell_ids) if i is not None}


def per_hit(vals, slots, id_of):
    """The per-hit loop ``index.hits.hits_from_arrays`` replaced, as its
    plain version: a numpy scalar, ``np.isfinite`` and an id lookup a hit."""
    out = []
    for row_v, row_s in zip(vals, slots):
        hits = []
        for v, s in zip(row_v, row_s):
            if not np.isfinite(v):
                continue
            id_ = id_of(int(s))
            if id_ is not None:
                hits.append((id_, float(v)))
        out.append(hits)
    return out


def per_row_merge(rows, extra, k):
    """The merge every IVF row took before ``index.hits.merge_hits``: extend,
    stable sort by -score, dedup, the first k."""
    out = []
    for hits, more in zip(rows, extra):
        hits = hits + more
        hits.sort(key=lambda h: -h[1])
        seen = set()
        uniq = []
        for h in hits:
            if h[0] not in seen:
                seen.add(h[0])
                uniq.append(h)
        out.append(uniq[:k])
    return out


def assert_hits_match(hits, ref_hits, tol: float) -> None:
    """Lists of (id, score) per query, as the index and planner return them."""
    assert len(hits) == len(ref_hits)
    for row, ref_row in zip(hits, ref_hits):
        assert len(row) == len(ref_row), (row, ref_row)
        assert_close([s for _, s in row], [s for _, s in ref_row], tol)
        got, want = dict(row), dict(ref_row)
        assert len(got) == len(row), f"duplicate ids in {row}"
        if not want:
            continue
        kth = min(want.values())
        for i in set(got) ^ set(want):
            v = got.get(i, want.get(i))
            assert abs(v - kth) <= _allowance(kth, tol), (i, v, kth, row, ref_row)


def assert_planes_match(planes, ref_planes, n_vals: int, tol: float) -> None:
    """Segment planes: the first ``n_vals`` are values (rank order), the rest
    member indices of ranks 1.. — equal wherever the value of that rank is
    more than ``tol`` from both neighbouring ranks."""
    vals = np.stack([to_np(p).astype(np.float64) for p in planes[:n_vals]])
    ref = np.stack([to_np(p).astype(np.float64) for p in ref_planes[:n_vals]])
    assert_close(vals, ref, tol)
    for t, (p, rp) in enumerate(zip(planes[n_vals:], ref_planes[n_vals:])):
        i, ri = to_np(p).astype(np.int64), to_np(rp).astype(np.int64)
        prev = ref[t - 1] if t else np.full_like(ref[0], np.inf)
        with np.errstate(invalid="ignore"):
            gap = np.minimum(prev - ref[t], ref[t] - ref[t + 1])
        sure = gap > _allowance(ref[t], tol)
        assert sure.mean() > 0.5, "too few separated ranks to check indices"
        np.testing.assert_array_equal(i[sure], ri[sure])


def assert_two_stage_match(hits, ref_hits, tol: float, prescan_of=None,
                           boundary=None, prescan_tol: float = 0.0) -> None:
    """Final hits of a two-stage search (a prescan keeps the top r
    candidates, an exact rescore ranks them) against a reference whose
    prescan summed in another order, so that the two candidate sets may
    differ at the r-th prescan score. An id may differ between the two only
    at a near tie of the final k-th score (``tol``) or at that boundary:
    ``prescan_of(row, id)`` is the id's prescan score and ``boundary[row]``
    the r-th one, within ``prescan_tol``. Scores of common ids agree within
    ``tol``."""
    assert len(hits) == len(ref_hits)
    for r, (row, ref_row) in enumerate(zip(hits, ref_hits)):
        got, want = dict(row), dict(ref_row)
        assert len(got) == len(row) and len(row) == len(ref_row), (row, ref_row)
        for i in set(got) & set(want):
            assert abs(got[i] - want[i]) <= _allowance(want[i], tol), (i, got[i], want[i])
        if not want:
            continue
        kth = min(min(want.values()), min(got.values()))
        for i in set(got) ^ set(want):
            v = got.get(i, want.get(i))
            if abs(v - kth) <= _allowance(kth, tol):
                continue
            assert prescan_of is not None and abs(prescan_of(r, i) - boundary[r]) <= \
                prescan_tol, (f"row {r}: id {i} (score {v}) differs away from the k-th "
                              f"score {kth} and from the prescan boundary: {row} vs {ref_row}")


def integer_case(n=8192, d=128, b=40, seed=0):
    """(v [n, d], q [b, d], w [n]) f32 CPU tensors for the segment kernels:
    small integers, so every sum is exact in f32 and ties are everywhere;
    three duplicates of one row inside one segment (block 1, column 5) and
    one segment whose rows all have weight 0 (block 0, column 9)."""
    g = np.random.default_rng(seed)
    v = g.integers(-2, 3, (n, d)).astype(np.float32)
    for m in (3, 7, 20):                      # duplicates inside one segment
        v[4096 + 5 + 128 * m] = v[77]
    q = g.integers(-2, 3, (b, d)).astype(np.float32)
    w = (g.random(n) > 0.05).astype(np.float32)
    w[[9 + 128 * m for m in range(32)]] = 0.0  # one all-invalid segment
    return torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(w)

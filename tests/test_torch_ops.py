"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and its
counterpart in ``grape_vector_db_tpu_torch.ops``. The Pallas kernels run in
interpret mode, as tests/test_ops.py runs them; the port runs the kernels'
plain PyTorch versions, which is what its wrappers do for CPU tensors.

Tolerances (absolute up to |score| 1, relative above; tests/torch_parity.py):
f32 storage 1e-5 (both engines sum f32 products in different orders); bf16
storage 1e-4 (bf16 operands, f32 sums, in different orders).
Member indices compare exactly wherever no near tie (within the tolerance)
separates the ranks; with integer-valued data every sum is exact in f32, so
there they compare exactly everywhere, ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grape_vector_db_tpu.ops import distance as jdist
from grape_vector_db_tpu.ops import segmax_pallas as jseg
from grape_vector_db_tpu_torch.ops import distance as tdist
from grape_vector_db_tpu_torch.ops import segmax as tseg
from torch_parity import assert_close, assert_planes_match, assert_topk_match, to_np

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _pair(x: np.ndarray, dtype: str):
    """The same rows for JAX and for torch, in the storage dtype."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _corpus(rng, n, d, b, p_valid=0.9):
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) < p_valid
    return v, q, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_score_block_matches_jax(rng, metric, dtype):
    v, q, valid = _corpus(rng, 512, 64, 8)
    jv, tv = _pair(v, dtype)
    norms = np.linalg.norm(to_np(tv), axis=1).astype(np.float32)
    jq = jdist.prepare_queries(jnp.asarray(q), metric)
    tq = tdist.prepare_queries(torch.from_numpy(q), metric)
    np.testing.assert_allclose(to_np(tq), np.asarray(jq), rtol=0, atol=1e-6)
    want = jdist.score_block(jq, jv, jnp.asarray(norms), jnp.asarray(valid), metric)
    got = tdist.score_block(tq, tv, torch.from_numpy(norms), torch.from_numpy(valid), metric)
    assert_close(to_np(got), np.asarray(want), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_scored_topk_matches_jax(rng, metric, dtype, monkeypatch):
    n, d, b = 1024, 64, 8
    v, q, valid = _corpus(rng, n, d, b)
    mask = rng.random(n) < 0.5
    jv, tv = _pair(v, dtype)
    norms = np.linalg.norm(to_np(tv), axis=1).astype(np.float32)
    tol = TOL[dtype]
    for k, m in ((10, None), (10, mask), (n + 5, None)):
        want = jdist.scored_topk(
            jnp.asarray(q), jv, jnp.asarray(norms), jnp.asarray(valid), k=k,
            metric=metric, chunk=256, mask=None if m is None else jnp.asarray(m))
        got = tdist.scored_topk(
            torch.from_numpy(q), tv, torch.from_numpy(norms), torch.from_numpy(valid),
            k=k, metric=metric, chunk=256,
            mask=None if m is None else torch.from_numpy(m))
        assert got[0].dtype == torch.float32 and got[0].shape == (b, k)
        assert_topk_match(*got, *want, tol=tol)
    # k > number of valid rows: the tail pads with (-inf, 0)
    assert to_np(got[1])[:, -5:].tolist() == [[0] * 5] * b
    assert np.isneginf(to_np(got[0])[:, -(n - valid.sum() + 5):]).all()
    # the chunked scan (the [B, N] budget lowered) returns the same top-k
    monkeypatch.setattr(tdist, "MAX_SCORE_ELEMS", b * 256)
    got = tdist.scored_topk(
        torch.from_numpy(q), tv, torch.from_numpy(norms), torch.from_numpy(valid),
        k=10, metric=metric, chunk=256, mask=torch.from_numpy(mask))
    want = jdist.scored_topk(
        jnp.asarray(q), jv, jnp.asarray(norms), jnp.asarray(valid), k=10,
        metric=metric, chunk=256, mask=jnp.asarray(mask))
    assert_topk_match(*got, *want, tol=tol)


def _planes(topj, q, v, valid, dtype, metric="cosine"):
    """(port plain-version planes, Pallas interpret-mode planes) for the same
    inputs, values first then member indices."""
    jv, tv = _pair(v, dtype)
    norms = np.linalg.norm(to_np(tv), axis=1).astype(np.float32)
    jq = jdist.prepare_queries(jnp.asarray(q), metric)
    jw = jseg.make_weight_plane(jnp.asarray(norms), jnp.asarray(valid), metric)
    tq = tdist.prepare_queries(torch.from_numpy(q), metric)
    tw = tseg.make_weight_plane(torch.from_numpy(norms), torch.from_numpy(valid), metric)
    np.testing.assert_array_equal(to_np(tw), np.asarray(jw)[0])
    if topj == 4:
        want = jseg.segmax4_scores_pallas(jq, jv, jw, interpret=True)
        got = tseg.segmax4_scores_ref(tq, tv, tw)
        return got, want
    m1, i1, m2 = jseg.segmax2_scores_pallas(jq, jv, jw, interpret=True)
    t1, ti, t2 = tseg.segmax2_scores_ref(tq, tv, tw)
    return (t1, t2, ti), (m1, m2, i1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topj", [4, 2])
def test_segmax_scores_ref_matches_pallas(rng, topj, dtype):
    v, q, valid = _corpus(rng, 8192, 128, 16)
    got, want = _planes(topj, q, v, valid, dtype)
    assert all(p.shape == (16, 8192 // 32) for p in got)
    assert all(p.dtype == torch.int32 for p in got[topj:])
    assert_planes_match(got, want, n_vals=topj, tol=TOL[dtype])


@pytest.mark.parametrize("topj", [4, 2])
def test_segmax_scores_ref_exact_ties_match_pallas(rng, topj):
    """Integer-valued rows and queries: every score is an exact integer in
    f32, so ties are common and both engines must order tied members the
    same way — (score descending, member ascending) — in every plane,
    including exact duplicate rows inside one segment and a segment whose
    rows are all invalid (its members come out as 0, 1, 2)."""
    n, d, b = 8192, 128, 16
    v = rng.integers(-2, 3, (n, d)).astype(np.float32)
    q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    for m in (3, 7, 20):                       # segment (blk 1, j 5)
        v[4096 + 5 + 128 * m] = v[77]
    valid = rng.random(n) > 0.05
    valid[[9 + 128 * m for m in range(32)]] = False  # segment (blk 0, j 9)
    got, want = _planes(topj, q, v, valid, "bfloat16", metric="dot")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert (to_np(got[0])[:, 9] == -np.inf).all()
    assert to_np(got[topj])[:, 9].tolist() == [0] * b


def _engines(topj):
    if topj == 4:
        return tseg.segmax4_topk, jseg.pallas_segmax4_topk
    return tseg.segmax2_topk, jseg.pallas_segmax2_topk


@pytest.mark.parametrize("k", [1, 2, 3, 4, 10, 33])
@pytest.mark.parametrize("topj", [4, 2])
def test_segmax_topk_matches_pallas(rng, topj, k):
    n, d, b = 8192, 128, 16
    v, q, valid = _corpus(rng, n, d, b)
    mask = rng.random(n) > 0.3
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    port, ref = _engines(topj)
    for metric in ("cosine", "dot"):
        got = port(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(norms),
                   torch.from_numpy(valid), k=k, metric=metric,
                   mask=torch.from_numpy(mask))
        want = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(norms),
                   jnp.asarray(valid), k=k, metric=metric, interpret=True,
                   mask=jnp.asarray(mask))
        assert_topk_match(*got, *want, tol=1e-5)
        assert np.isin(to_np(got[1]), np.flatnonzero(valid & mask)).all()


@pytest.mark.parametrize("topj", [4, 2])
def test_segmax_topk_adversarial_placements(rng, topj):
    """The placements of tests/test_ops.py's segmax4 test: twelve near
    duplicates of one strong row inside one segment (ranks 4.. reachable
    only through the rescore), and pairs and triples of boosted rows spread
    across segments (the rank-2/3 known-candidate pools)."""
    n, d, b, k = 8192, 128, 16, 10
    v, q, _ = _corpus(rng, n, d, b)
    valid = np.ones(n, bool)
    port, ref = _engines(topj)
    v2 = v.copy()
    for m in range(12):
        v2[4096 + 5 + m * 128] = v2[77] * (1.0 + 1e-4 * m)
    v3 = v.copy()
    strong = rng.standard_normal(d).astype(np.float32) * 3.0
    for blk, j, members in [(0, 9, (0, 1)), (0, 30, (2, 5, 9)), (1, 9, (4, 7)),
                            (1, 77, (0, 3, 8))]:
        for t, m in enumerate(members):
            v3[blk * 4096 + j + m * 128] = strong * (1.0 + 1e-3 * t)
    for vv in (v2, v3):
        norms = np.linalg.norm(vv, axis=1).astype(np.float32)
        got = port(torch.from_numpy(q), torch.from_numpy(vv), torch.from_numpy(norms),
                   torch.from_numpy(valid), k=k, metric="dot")
        want = ref(jnp.asarray(q), jnp.asarray(vv), jnp.asarray(norms),
                   jnp.asarray(valid), k=k, metric="dot", interpret=True)
        assert_topk_match(*got, *want, tol=1e-5)
        # each returned row's own score is the value returned beside it
        true = q.astype(np.float64) @ vv.astype(np.float64).T
        np.testing.assert_allclose(np.take_along_axis(true, to_np(got[1]), axis=1),
                                   to_np(got[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("topj", [4, 2])
def test_segmax_topk_degenerate_validity(rng, topj):
    """tests/test_ops.py's degenerate-validity case: a large capacity holding
    only three fully valid segments (96 rows), fewer than the segments the
    selections pick. No id may repeat and every id must be valid."""
    n, d, b, k = 8192, 128, 4, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    valid = np.zeros(n, bool)
    valid_rows = np.array([j + m * 128 for j in (0, 1, 2) for m in range(32)])
    valid[valid_rows] = True
    q = rng.standard_normal((b, d)).astype(np.float32)
    port, ref = _engines(topj)
    got = port(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(norms),
               torch.from_numpy(valid), k=k, metric="dot")
    want = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(norms),
               jnp.asarray(valid), k=k, metric="dot", interpret=True)
    assert_topk_match(*got, *want, tol=1e-5)
    oracle = -np.sort(-(q.astype(np.float64) @ v[valid_rows].astype(np.float64).T), axis=1)
    np.testing.assert_allclose(to_np(got[0]), oracle[:, :k], rtol=1e-4, atol=1e-4)
    for row in to_np(got[1]):
        assert len(set(row.tolist())) == k
        assert set(row.tolist()) <= set(valid_rows.tolist())


def test_dup_pick_mask_matches_jax():
    seg = np.array([[3, 0, 3, 0, 7], [1, 2, 3, 4, 5]], np.int64)
    np.testing.assert_array_equal(
        to_np(tseg._dup_pick_mask(torch.from_numpy(seg))),
        np.asarray(jseg._dup_pick_mask(jnp.asarray(seg))))


@pytest.mark.parametrize("k", [3, 10])
def test_scored_topk_segmax_route_matches_jax(rng, monkeypatch, k):
    """With the routing constants lowered, the port's scored_topk takes the
    segment engine at N=8192 and still returns JAX's exact top-k."""
    n, d, b = 8192, 128, 16
    v, q, valid = _corpus(rng, n, d, b)
    jv, tv = _pair(v, "bfloat16")
    norms = np.linalg.norm(to_np(tv), axis=1).astype(np.float32)
    calls = []
    for name in ("segmax4_scores", "segmax2_scores"):
        fn = getattr(tseg, name)
        monkeypatch.setattr(tseg, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 4096)
    got = tdist.scored_topk(torch.from_numpy(q), tv, torch.from_numpy(norms),
                            torch.from_numpy(valid), k=k, metric="cosine", chunk=8192)
    want = jdist.scored_topk(jnp.asarray(q), jv, jnp.asarray(norms), jnp.asarray(valid),
                             k=k, metric="cosine", chunk=8192)
    assert calls == ["segmax4_scores" if k >= 4 else "segmax2_scores"]
    assert_topk_match(*got, *want, tol=1e-4)


def test_segmax_kernel_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only: a CPU tensor reaches the
    plain version through the wrapper, never the launcher."""
    v = torch.zeros(4096, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tseg._launch(4, torch.zeros(8, 128), v, torch.ones(4096))

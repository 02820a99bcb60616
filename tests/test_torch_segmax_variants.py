"""The segment-max variants B7-B10 and their entry points, against the JAX
package, on the CPU.

The same numpy inputs (made from a seed) go through the Pallas kernels in
interpret mode, as tests/test_ops.py runs them, and through the port's plain
versions, which is what its wrappers run for CPU tensors:

- B9 ``segmax_scores`` and B10 ``segmax_scores_contig`` (segment maxima,
  strided and contiguous), B7 ``segmax4_sup_scores`` (B1's planes plus the
  block maxima s1, s2) and B8 ``segmax2_scores(impl="selfold")`` (B2's
  values, another member on ties);
- the entry points ``segmax_topk`` (both layouts), ``segmax4_topk(impl=
  "sup")`` and ``segmax2_topk(impl="selfold")`` against
  ``pallas_segmax_topk``, ``pallas_segmax4_topk`` and
  ``pallas_segmax2_topk``, mirroring tests/test_ops.py.

Tolerances (absolute up to |score| 1, relative above; tests/torch_parity.py):
f32 storage 1e-5 (both engines sum f32 products in different orders), bf16
storage 1e-4 (bf16 operands, f32 sums in different orders). Member indices
compare exactly wherever no near tie separates the ranks; on integer data
every sum is exact in f32, so there every plane compares exactly, ties
included. Top-k ids compare as sets with the near-tie guard.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grape_vector_db_tpu.ops import distance as jdist
from grape_vector_db_tpu.ops import segmax_pallas as jseg
from grape_vector_db_tpu_torch.ops import distance as tdist
from grape_vector_db_tpu_torch.ops import segmax as tseg
from torch_parity import (assert_close, assert_planes_match, assert_topk_match,
                          integer_case, to_np)

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-4}
KERNELS = ["segmax", "segmax_contig", "segmax4_sup", "segmax2_selfold"]


def _bitrev5(m: int) -> int:
    return int(f"{m:05b}"[::-1], 2)


def _inputs(q, v, w_or_valid, dtype, metric=None, norms=None):
    """(JAX args, port args) of a phase-1 call. With ``metric`` the queries
    are prepared and the weight plane made from ``norms`` and validity;
    without, ``w_or_valid`` is the weight itself (integer cases)."""
    jv = jnp.asarray(v).astype(dtype)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    if metric is None:
        w = np.asarray(w_or_valid, np.float32)
        return (jnp.asarray(q), jv, jnp.asarray(w)), (torch.from_numpy(q), tv,
                                                        torch.from_numpy(w))
    jq = jdist.prepare_queries(jnp.asarray(q), metric)
    tq = tdist.prepare_queries(torch.from_numpy(q), metric)
    tw = tseg.make_weight_plane(torch.from_numpy(norms), torch.from_numpy(w_or_valid), metric)
    return (jq, jv, jnp.asarray(to_np(tw))), (tq, tv, tw)


def _run(kernel, jargs, targs):
    """(port planes, Pallas planes) of one kernel: values first (rank
    order), then member indices, then (B7) s1 and s2."""
    jq, jv, jw = jargs
    tq, tv, tw = targs
    w8 = jnp.broadcast_to(jw[None, :], (8, jw.shape[0]))
    if kernel == "segmax":
        return ((tseg.segmax_scores_ref(tq, tv, tw),),
                (jseg.segmax_scores_pallas(jq, jv, w8, interpret=True),))
    if kernel == "segmax_contig":
        return ((tseg.segmax_scores_contig_ref(tq, tv, tw),),
                (jseg.segmax_scores_pallas_contig(jq, jv, w8.T, interpret=True),))
    if kernel == "segmax4_sup":
        return (tseg.segmax4_sup_scores_ref(tq, tv, tw),
                jseg.segmax4_sup_scores_pallas(jq, jv, w8, interpret=True))
    m1, i1, m2 = jseg.segmax2_scores_pallas(jq, jv, w8, interpret=True, impl="selfold")
    t1, ti, t2 = tseg.segmax2_scores_ref(tq, tv, tw, impl="selfold")
    return (t1, t2, ti), (m1, m2, i1)


N_VALS = {"segmax": 1, "segmax_contig": 1, "segmax4_sup": 4, "segmax2_selfold": 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_match_pallas(rng, kernel, dtype):
    n, d, b = (12_288 if kernel == "segmax4_sup" else 8192), 128, 24
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) < 0.9
    if kernel == "segmax4_sup":
        valid[4096:8192] = False            # one block with no valid row
    norms = np.linalg.norm(to_np(torch.from_numpy(v).to(getattr(torch, dtype))),
                           axis=1).astype(np.float32)
    got, want = _run(kernel, *_inputs(q, v, valid, dtype, "cosine", norms))
    shape = (n // 32, b) if kernel == "segmax_contig" else (b, n // 32)
    assert all(tuple(p.shape) == shape for p in got[:N_VALS[kernel]])
    nv = N_VALS[kernel]
    if kernel == "segmax4_sup":
        # s1, s2: the block maxima of the port's own m1, m2, exactly; an
        # all-invalid block (block 1) gives -inf
        s1, s2 = got[7:]
        assert s1.shape == s2.shape == (b, n // 4096)
        for s, m in ((s1, got[0]), (s2, got[1])):
            assert torch.equal(s, m.view(b, n // 4096, 128).amax(dim=2))
        assert torch.isneginf(s1[:, 1]).all()
        assert_close(np.stack([to_np(x) for x in got[7:]]),
                     np.stack([np.asarray(x) for x in want[7:]]), TOL[dtype])
        got, want = got[:7], want[:7]
    if nv == 1:
        assert_close(to_np(got[0]), np.asarray(want[0]), TOL[dtype])
    else:
        assert_planes_match(got, want, n_vals=nv, tol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_exact_on_integers(kernel, dtype):
    """tests/test_torch_cuda.py's integer case (exact sums, ties everywhere,
    duplicate rows inside one segment, one all-invalid segment): every plane
    equals the Pallas kernel's, B8's member indices included."""
    v, q, w = (to_np(x) for x in integer_case())
    got, want = _run(kernel, *_inputs(q, v, w, dtype))
    for g, p in zip(got, want):
        np.testing.assert_array_equal(to_np(g).astype(np.float64),
                                      np.asarray(p).astype(np.float64))


def test_selfold_tie_rule(rng):
    """B8's i1 is, among each segment's tied maxima, the member with the
    smallest 5-bit bit-reversed index (B2's is the smallest index): checked
    against a direct numpy reading of the scores, and shown to differ from
    B2's somewhere on the integer case."""
    v, q, w = integer_case()
    m1, i1, m2 = tseg.segmax2_scores_ref(q, v, w, impl="selfold")
    e1, ei, e2 = tseg.segmax2_scores_ref(q, v, w, impl="eqfold")
    assert torch.equal(m1, e1) and torch.equal(m2, e2)
    assert (i1 != ei).any()
    s = to_np(q).astype(np.float64) @ to_np(v).astype(np.float64).T
    s = np.where(to_np(w)[None, :] == 0, -np.inf, s * to_np(w)[None, :])
    b, n = s.shape
    s = s.reshape(b, n // 4096, 32, 128).transpose(0, 1, 3, 2).reshape(b, n // 32, 32)
    tied = s == s.max(axis=2, keepdims=True)
    rev = np.array([_bitrev5(m) for m in range(32)])
    want_self = np.argmin(np.where(tied, rev[None, None, :], 99), axis=2)
    want_eq = np.argmax(tied, axis=2)
    np.testing.assert_array_equal(to_np(i1), want_self)
    np.testing.assert_array_equal(to_np(ei), want_eq)
    with pytest.raises(ValueError, match="impl"):
        tseg.segmax2_scores(q, v, w, impl="fold")


# -- the entry points ---------------------------------------------------------------


def _corpus(rng, n=8192, d=128, b=16, p_valid=0.9):
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) < p_valid
    return v, q, valid, np.linalg.norm(v, axis=1).astype(np.float32)


def _both(port, ref, v, q, valid, norms, k, metric, mask=None, **kw):
    got = port(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(norms),
               torch.from_numpy(valid), k=k, metric=metric,
               mask=None if mask is None else torch.from_numpy(mask), **kw)
    want = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(norms), jnp.asarray(valid),
               k=k, metric=metric, interpret=True,
               mask=None if mask is None else jnp.asarray(mask), **kw)
    return got, want


@pytest.mark.parametrize("select", ["auto", "iterative", "verified", "twolevel"])
@pytest.mark.parametrize("layout", ["strided", "contig"])
def test_segmax_topk_matches_pallas(rng, layout, select):
    """tests/test_ops.py:298-328: both layouts x every select x cosine/dot,
    then a mask; every selection is exact in the port."""
    v, q, valid, norms = _corpus(rng)
    for metric in ("cosine", "dot"):
        got, want = _both(tseg.segmax_topk, jseg.pallas_segmax_topk, v, q, valid, norms,
                          10, metric, layout=layout, select=select)
        assert_topk_match(*got, *want, tol=1e-5)
    mask = rng.random(len(v)) > 0.7
    got, want = _both(tseg.segmax_topk, jseg.pallas_segmax_topk, v, q, valid, norms,
                      10, "cosine", mask, layout=layout, select=select)
    assert_topk_match(*got, *want, tol=1e-5)
    assert np.isin(to_np(got[1]), np.flatnonzero(valid & mask)).all()


@pytest.mark.parametrize("k", [1, 2, 10, 33])
def test_segmax2_selfold_topk_matches_pallas(rng, k):
    """tests/test_ops.py:330-374: selfold at k = 1, 2, 10, 33 for cosine and
    dot, a mask, and twelve near duplicates stacked in one segment (rows
    3.. reachable only through the m2 rescore)."""
    v, q, valid, norms = _corpus(rng)
    eng = functools.partial(tseg.segmax2_topk, impl="selfold")
    ref = functools.partial(jseg.pallas_segmax2_topk, impl="selfold")
    for metric in ("cosine", "dot"):
        got, want = _both(eng, ref, v, q, valid, norms, k, metric)
        assert_topk_match(*got, *want, tol=1e-5)
    mask = rng.random(len(v)) > 0.7
    got, want = _both(eng, ref, v, q, valid, norms, k, "cosine", mask)
    assert_topk_match(*got, *want, tol=1e-5)
    v2 = v.copy()
    for m in range(12):
        v2[4096 + 5 + m * 128] = v2[77] * (1.0 + 1e-4 * m)
    n2 = np.linalg.norm(v2, axis=1).astype(np.float32)
    ones = np.ones(len(v), bool)
    got, want = _both(eng, ref, v2, q, ones, n2, k, "dot")
    assert_topk_match(*got, *want, tol=1e-5)
    true = q.astype(np.float64) @ v2.astype(np.float64).T
    np.testing.assert_allclose(np.take_along_axis(true, to_np(got[1]), axis=1),
                               to_np(got[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [12_288, 8192])
def test_segmax4_sup_topk_matches_plain_and_exact(rng, n):
    """tests/test_ops.py:461-531: impl="sup" equals impl="plain" and the
    exact oracle, at nblocks >= kk (the two-level selection from s1/s2) and
    at nblocks < kk (the full-plane fallback); ids distinct and rescoring
    to their values; then a masked search."""
    d, b = 128, 4
    v, q, valid, norms = _corpus(rng, n, d, b)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    true = np.where(valid[None, :], qn.astype(np.float64) @ vn.astype(np.float64).T, -np.inf)
    ref = functools.partial(jseg.pallas_segmax4_topk, impl="sup")
    for k in (1, 3, 4, 10, 33):
        got, want = _both(functools.partial(tseg.segmax4_topk, impl="sup"), ref, v, q,
                          valid, norms, k, "cosine")
        assert_topk_match(*got, *want, tol=1e-5)
        plain = tseg.segmax4_topk(torch.from_numpy(q), torch.from_numpy(v),
                                  torch.from_numpy(norms), torch.from_numpy(valid), k=k)
        assert_topk_match(*got, *plain, tol=1e-5)
        assert torch.equal(got[0], plain[0])
        oracle = -np.sort(-true, axis=1)[:, :k]
        np.testing.assert_allclose(to_np(got[0]), np.minimum(oracle, 1.0), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(np.take_along_axis(true, to_np(got[1]), axis=1),
                                   np.minimum(to_np(got[0]), 1.0), rtol=1e-4, atol=1e-4)
        for row in to_np(got[1]):
            assert len(set(row.tolist())) == len(row)
    mask = rng.random(n) > 0.7
    got, want = _both(functools.partial(tseg.segmax4_topk, impl="sup"), ref, v, q,
                      np.ones(n, bool), norms, 10, "cosine", mask)
    assert_topk_match(*got, *want, tol=1e-5)


def test_twolevel_selection_is_exact(rng):
    """The two-level selection from precomputed block maxima returns
    torch.topk's values, with -inf columns, at ns >= kk and in its
    fallback (ns < kk)."""
    plane = torch.from_numpy(rng.standard_normal((5, 12 * 128)).astype(np.float32))
    plane[:, ::3] = float("-inf")
    plane[1, :] = float("-inf")
    plane[1, 700] = 2.0
    sup = plane.view(5, 12, 128).amax(dim=2)
    for kk in (1, 7, 12, 13, 40):
        vals, cols = tseg._twolevel_topk_pre(plane, kk, sup)
        want, _ = torch.topk(plane, kk, dim=1)
        assert torch.equal(vals, want)
        assert torch.equal(torch.gather(plane, 1, cols), vals)


ENGINES = {
    "strided": (tseg.segmax_topk, jseg.pallas_segmax_topk, {}),
    "contig": (tseg.segmax_topk, jseg.pallas_segmax_topk, {"layout": "contig"}),
    "segmax4_sup": (tseg.segmax4_topk, jseg.pallas_segmax4_topk, {"impl": "sup"}),
    "segmax2_selfold": (tseg.segmax2_topk, jseg.pallas_segmax2_topk, {"impl": "selfold"}),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_degenerate_validity_no_duplicate_ids(rng, engine):
    """tests/test_ops.py:577-613: a large capacity holding three fully valid
    strided segments (96 rows), fewer than the segments the selections
    pick. No id may repeat, every id must be valid, and the values are the
    float64 oracle's."""
    n, d, b, k = 8192, 128, 4, 10
    v, q, _, norms = _corpus(rng, n, d, b)
    valid = np.zeros(n, bool)
    rows = np.array([j + m * 128 for j in (0, 1, 2) for m in range(32)])
    valid[rows] = True
    port, ref, kw = ENGINES[engine]
    got, want = _both(functools.partial(port, **kw), functools.partial(ref, **kw), v, q,
                      valid, norms, k, "dot")
    assert_topk_match(*got, *want, tol=1e-5)
    oracle = -np.sort(-(q.astype(np.float64) @ v[rows].astype(np.float64).T), axis=1)
    np.testing.assert_allclose(to_np(got[0]), oracle[:, :k], rtol=1e-4, atol=1e-4)
    for row in to_np(got[1]):
        assert len(set(row.tolist())) == k
        assert set(row.tolist()) <= set(rows.tolist())


def test_unknown_options_raise(rng):
    v, q, valid, norms = (torch.from_numpy(x) for x in _corpus(rng, b=2))
    args = (q, v, norms, valid, 3)
    for fn, kw in ((tseg.segmax_topk, {"layout": "rows"}),
                   (tseg.segmax_topk, {"select": "approx"}),
                   (tseg.segmax4_topk, {"impl": "fused"}),
                   (tseg.segmax4_topk, {"select": "verified"}),
                   (tseg.segmax2_topk, {"impl": "fold"}),
                   (tseg.segmax2_topk, {"select": "max"})):
        with pytest.raises(ValueError):
            fn(*args, **kw)


def test_entry_points_are_exported():
    from grape_vector_db_tpu_torch import ops

    assert ops.segmax_topk is tseg.segmax_topk
    assert ops.segmax4_topk is tseg.segmax4_topk
    assert ops.segmax2_topk is tseg.segmax2_topk


@pytest.mark.parametrize("instance", list(tseg._INSTANCES))
def test_kernel_routing_by_instance_and_storage(instance):
    """Every instance (B1, B2, B7, B8, B9, B10) in bf16 storage launches the
    TMA + wgmma kernel of csrc/segmax_max.cu, and in f32 storage the
    csrc/segmax.cu template. Both sources ship with the package."""
    import os

    assert tseg._library(instance, torch.float32) == "segmax"
    assert tseg._library(instance, torch.bfloat16) == "segmax_max"
    csrc = os.path.join(os.path.dirname(tseg.__file__), os.pardir, "csrc")
    for lib in ("segmax", "segmax_max"):
        assert os.path.exists(os.path.join(csrc, f"{lib}.cu"))

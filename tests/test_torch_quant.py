"""The port's kernel-free quantized kinds against the JAX package, on the CPU:
the int8 and PQ flat kinds (ops/int8.py ``int8_topk``, ops/pq.py,
index/int8.py, index/pq.py), IVF-PQ (index/ivf_pq.py) and the projected IVF
kinds (index/ivf_proj.py), plus ``build_index`` for every kind this slice
adds.

Deterministic indexes (int8, PQ before training) are built from the same
numpy inputs in both packages. Trained state (PQ codebooks, IVF centroids,
the PCA projection) comes from ``jax.random`` starts or ``eigh`` signs the
port cannot reproduce, so the JAX index's arrays are carried into the port
with ``load_state``; the training itself is compared from shared starts
(``train_pq``) or by the subspace (``_fit_projection``).

Tolerances: quantized prescan scores 1e-5 (relative above 1; f32 sums in
another order), rescored scores 1e-4 (f32 sums of exact bf16 products), hits
as id sets with the near-tie guard (tests/torch_parity.py); where a prescan
keeps the top r candidates, ids may also differ at a near tie (1e-4) of the
r-th prescan score.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from grape_vector_db_tpu.index.int8 import Int8DeviceIndex as JaxInt8
from grape_vector_db_tpu.index.ivf_pq import IvfPqDeviceIndex as JaxIvfPq
from grape_vector_db_tpu.index.ivf_proj import ProjectedInt4IvfIndex as JaxProj4
from grape_vector_db_tpu.index.ivf_proj import ProjectedInt8IvfIndex as JaxProj8
from grape_vector_db_tpu.index.ivf_proj import _fit_projection as j_fit_projection
from grape_vector_db_tpu.index.pq import PqDeviceIndex as JaxPq
from grape_vector_db_tpu.ops import int8 as j_int8
from grape_vector_db_tpu.ops import pq as j_pq
from grape_vector_db_tpu_torch import VectorDbConfig
from grape_vector_db_tpu_torch.db import build_index
from grape_vector_db_tpu_torch.index import (BinaryDeviceIndex, Int8DeviceIndex,
                                             IvfPqDeviceIndex, PqDeviceIndex,
                                             ProjectedInt4IvfIndex, ProjectedInt8IvfIndex)
from grape_vector_db_tpu_torch.index.ivf_proj import _fit_projection
from grape_vector_db_tpu_torch.ops import int8 as t_int8
from grape_vector_db_tpu_torch.ops import pq as t_pq
from torch_parity import (assert_hits_match, assert_topk_match, assert_two_stage_match,
                          cell_map, to_np)

torch.set_num_threads(2)

D = 64
PRE_TOL = 1e-5      # quantized prescan scores (relative above 1)
TOL = 1e-4          # rescored scores
BOUNDARY_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _clustered(rng, n, k=12, d=D, spread=0.3):
    centers = rng.standard_normal((k, d)).astype(np.float32)
    return (centers[rng.integers(0, k, n)]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _prescan_guard(t, q, k, scores_fn, mask=None):
    """(prescan_of, boundary) for ``assert_two_stage_match`` from the port's
    own prescan scores over every allowed row ([B, capacity], -inf where
    invalid)."""
    pre = to_np(scores_fn(_t(q))).astype(np.float64)
    if mask is not None:
        pre = np.where(mask[None, :], pre, -np.inf)
    r = t._rescore_count(k)
    boundary = -np.sort(-pre, axis=1)[:, min(r, pre.shape[1]) - 1]
    slot = t._id_to_slot
    return (lambda row, i: pre[row, slot[i]]), boundary


# -- int8 ----------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [256, 1024])
def test_int8_topk_matches_jax(rng, chunk):
    x = rng.standard_normal((1024, D)).astype(np.float32)
    codes, scales = j_int8.quantize_int8(jnp.asarray(x))
    factor = np.asarray(scales) / np.linalg.norm(x, axis=1)
    valid = rng.random(1024) > 0.1
    q = rng.standard_normal((6, D)).astype(np.float32)
    jv, ji = j_int8.int8_topk(jnp.asarray(q), codes, jnp.asarray(factor), jnp.asarray(valid),
                              k=40, chunk=chunk)
    tv, ti = t_int8.int8_topk(_t(q), _t(np.asarray(codes)), _t(factor), _t(valid), k=40,
                              chunk=chunk)
    assert_topk_match(tv, ti, np.asarray(jv), np.asarray(ji), PRE_TOL)


def test_int8_dots_are_exact_past_1040_lanes(rng):
    """D = 8192 codes near 127: the int32 products (~1e8) pass 2^24, where one
    f32-accumulated product rounds; the port sums 1040-lane slices in
    int32, so its dots equal the exact integer products cast to f32 once, as
    the reference's int32 -> f32 cast does. int8_topk at that width matches
    the reference within the prescan tolerance."""
    d = 8192
    qi = rng.integers(100, 128, (4, d)).astype(np.int8)
    codes = rng.integers(100, 128, (64, d)).astype(np.int8)
    want = (qi.astype(np.int64) @ codes.astype(np.int64).T).astype(np.float32)
    got = t_int8._int8_dots(_t(qi).to(torch.bfloat16), _t(codes))
    assert t_int8.EXACT_LANES < d and want.max() > 2**24
    np.testing.assert_array_equal(to_np(got), want)

    x = rng.uniform(0.9, 1.0, (256, d)).astype(np.float32)
    jcodes, scales = j_int8.quantize_int8(jnp.asarray(x))
    factor = np.asarray(scales) / np.linalg.norm(x, axis=1)
    valid = np.ones(256, bool)
    q = rng.uniform(0.9, 1.0, (4, d)).astype(np.float32)
    jv, ji = j_int8.int8_topk(jnp.asarray(q), jcodes, jnp.asarray(factor), jnp.asarray(valid),
                              k=40)
    tv, ti = t_int8.int8_topk(_t(q), _t(np.asarray(jcodes)), _t(factor), _t(valid), k=40)
    assert_topk_match(tv, ti, np.asarray(jv), np.asarray(ji), PRE_TOL)


def _int8_prescan(t):
    def fn(q):
        factor = t.scales / torch.clamp(t.norms, min=1e-12) if t.metric == "cosine" \
            else t.scales
        v, s = t_int8.int8_topk(q, t.codes, factor, t.valid, k=t.capacity)
        return torch.full((q.shape[0], t.capacity), float("-inf")).scatter(1, s, v)
    return fn


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_int8_index_matches_jax(rng, metric):
    kw = dict(metric=metric, initial_capacity=256, rescore=16)
    j, t = JaxInt8(D, **kw), Int8DeviceIndex(D, device="cpu", **kw)
    x = _clustered(rng, 900)
    ids = [f"d{i}" for i in range(900)]
    for idx in (j, t):
        idx.add_batch(ids[:300], x[:300])
        idx.add_batch(ids[300:], x[300:])                  # grows 256 -> 1024
        idx.remove_batch(ids[:20])
        idx.add_batch(["n1", "n2"], x[:2] + 0.01)          # reuses freed slots
    assert t._slot_to_id == j._slot_to_id and t.capacity == j.capacity == 1024
    np.testing.assert_array_equal(to_np(t.codes), np.asarray(j.codes))
    np.testing.assert_array_equal(to_np(t.scales), np.asarray(j.scales))
    q = np.concatenate([x[20:24] + 0.05, _clustered(rng, 4)])
    for mask_ids in (None, {f"d{i}" for i in range(0, 900, 3)}):
        mt = mj = None
        if mask_ids is not None:
            mt, mj = t.compile_mask(mask_ids), j.compile_mask(mask_ids)
        got, want = t.search_batch(q, 10, mask=mt), j.search_batch(q, 10, mask=mj)
        guard = _prescan_guard(t, q, 10, _int8_prescan(t), mt)
        assert_two_stage_match(got, want, TOL, *guard, BOUNDARY_TOL)
        if mask_ids is not None:
            assert all(i in mask_ids for row in got for i, _ in row)
    assert t.get_stats().extra == j.get_stats().extra
    with pytest.raises(ValueError, match="cosine/dot"):
        Int8DeviceIndex(D, metric="euclidean", device="cpu")


# -- PQ ------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [4, 6])
def test_train_pq_from_shared_starts_matches_jax(rng, nbits):
    """JAX draws each subspace's start with jax.random.choice(seed + s); the
    same draws start the port's Lloyd steps."""
    n, n_sub, seed = 1500, 4, 3
    x = _clustered(rng, n, k=20, d=32)
    want = np.asarray(j_pq.train_pq(jnp.asarray(x), n_sub=n_sub, nbits=nbits, iters=5, seed=seed))
    subs = x.reshape(n, n_sub, -1)
    init = np.stack([subs[np.asarray(jax.random.choice(jax.random.PRNGKey(seed + s), n,
                                                       shape=(2 ** nbits,), replace=False)), s]
                     for s in range(n_sub)])
    got = t_pq.train_pq(_t(x), n_sub=n_sub, nbits=nbits, iters=5, init=_t(init))
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-4)
    own = t_pq.train_pq(_t(x), n_sub=n_sub, nbits=nbits, iters=2, seed=seed)
    assert own.shape == want.shape
    with pytest.raises(ValueError, match="training vectors"):
        t_pq.train_pq(_t(x[:10]), n_sub=n_sub, nbits=nbits)


def test_encode_pq_and_adc_topk_match_jax(rng):
    x = _clustered(rng, 1024)
    books = j_pq.train_pq(jnp.asarray(x[:600]), n_sub=8, nbits=8, iters=3)
    cb = np.asarray(books)
    want = np.asarray(j_pq.encode_pq(jnp.asarray(x), books))
    got = to_np(t_pq.encode_pq(_t(x), _t(cb)))
    assert got.dtype == np.uint8
    # equal except where the two nearest codewords lie within 1e-5
    subs = x.reshape(1024, 8, 8).astype(np.float64)
    d2 = ((subs[:, :, None, :] - cb[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d2, axis=-1)[:, :, :2]
    sure = two[:, :, 1] - two[:, :, 0] > 1e-5
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[sure], want[sure])
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    valid = rng.random(1024) > 0.1
    q = rng.standard_normal((6, D)).astype(np.float32)
    for chunk in (256, 1024):
        jv, ji = j_pq.adc_topk(jnp.asarray(q), books, jnp.asarray(want), jnp.asarray(norms),
                               jnp.asarray(valid), k=50, chunk=chunk)
        tv, ti = t_pq.adc_topk(_t(q), _t(cb), _t(want), _t(norms), _t(valid), k=50, chunk=chunk)
        assert_topk_match(tv, ti, np.asarray(jv), np.asarray(ji), PRE_TOL)


def _flat_state(j) -> dict:
    return dict(vectors=np.asarray(j.vectors), norms=np.asarray(j.norms),
                valid=np.asarray(j.valid), slot_to_id=j._slot_to_id, free=j._free,
                high_water=j._high_water)


def _pq_prescan(t):
    def fn(q):
        v, s = t_pq.adc_topk(q, t.codebooks, t.codes, t.norms, t.valid, k=t.capacity)
        return torch.full((q.shape[0], t.capacity), float("-inf")).scatter(1, s, v)
    return fn


def test_pq_index_before_and_after_training(rng):
    kw = dict(initial_capacity=512, n_sub=8, rescore_ratio=0.05)
    j, t = JaxPq(D, **kw), PqDeviceIndex(D, device="cpu", **kw)
    x = _clustered(rng, 1400)
    ids = [f"d{i}" for i in range(1400)]
    q = np.concatenate([x[:4] + 0.05, _clustered(rng, 4)])
    for idx in (j, t):
        idx.add_batch(ids[:700], x[:700])                  # below train_threshold 1024
    assert not t.is_trained and not j.is_trained
    assert_hits_match(t.search_batch(q, 10), j.search_batch(q, 10), TOL)   # exact scan
    j.add_batch(ids[700:], x[700:])                         # trains the JAX codebooks
    assert j.is_trained
    t.load_state(**_flat_state(j), codes=np.asarray(j.codes), codebooks=np.asarray(j.codebooks))
    assert t.is_trained and t._rescore_count(10) == 128 < len(t)
    got = t.search_batch(q, 10)
    assert_two_stage_match(got, j.search_batch(q, 10), TOL,
                           *_prescan_guard(t, q, 10, _pq_prescan(t)), BOUNDARY_TOL)
    mask_ids = {f"d{i}" for i in range(0, 1400, 5)}
    mt, mj = t.compile_mask(mask_ids), j.compile_mask(mask_ids)
    got = t.search_batch(q, 10, mask=mt)
    assert_two_stage_match(got, j.search_batch(q, 10, mask=mj), TOL,
                           *_prescan_guard(t, q, 10, _pq_prescan(t), mt), BOUNDARY_TOL)
    assert all(i in mask_ids for row in got for i, _ in row)
    # new rows are encoded with the carried codebooks, as in JAX
    for idx in (j, t):
        idx.remove_batch(ids[:10])
        idx.add_batch(["n1", "n2", "n3"], x[:3] * 1.5)
    slots = [t._id_to_slot[i] for i in ("n1", "n2", "n3")]
    np.testing.assert_array_equal(to_np(t.codes)[slots], np.asarray(j.codes)[slots])
    assert t.get_stats().extra == j.get_stats().extra


def test_pq_index_own_training(rng):
    t = PqDeviceIndex(D, initial_capacity=512, n_sub=8, device="cpu")
    x = _clustered(rng, 1300)
    t.add_batch([f"d{i}" for i in range(1000)], x[:1000])
    assert not t.is_trained
    t.add_batch([f"d{i}" for i in range(1000, 1300)], x[1000:])   # crosses 1024: trains
    assert t.is_trained and t.codebooks.shape == (8, 256, 8)
    for i, row in zip((0, 1200), t.search_batch(x[[0, 1200]], 3)):
        assert row[0][0] == f"d{i}" and row[0][1] == pytest.approx(1.0, abs=3e-3)
    t.optimize()
    assert t.get_stats().is_built


# -- IVF-PQ --------------------------------------------------------------------


def _ivf_state(j) -> dict:
    """A JAX IVF index's state, read back as numpy, for ``load_state``."""
    o = j._overflow
    return dict(centroids=np.asarray(j.centroids), norms=np.asarray(j.norms),
                valid=np.asarray(j.valid), list_cap=j.list_cap, next_pos=j._next_pos,
                free=j._free, id_to_cell=j._id_to_cell,
                vecs=None if j.vecs is None else np.asarray(j.vecs),
                recip=None if j.recip is None else np.asarray(j.recip),
                overflow=dict(vectors=np.asarray(o.vectors), norms=np.asarray(o.norms),
                              valid=np.asarray(o.valid), slot_to_id=o._slot_to_id,
                              free=o._free, high_water=o._high_water))


def _ivfpq_state(j) -> dict:
    st = _ivf_state(j)
    st.update(codes=np.asarray(j.codes),
              codebooks=None if j.codebooks is None else np.asarray(j.codebooks),
              codes8=None if j.codes8 is None else np.asarray(j.codes8),
              scales8=None if j.scales8 is None else np.asarray(j.scales8))
    return st


@pytest.mark.parametrize("resident", ["bf16", "int8", "none"])
@pytest.mark.parametrize("residual", [True, False])
def test_ivf_pq_matches_jax_on_carried_state(rng, resident, residual):
    kw = dict(nlist=8, nprobe=3, initial_capacity=512, n_sub=8, residual=residual,
              resident=resident)
    j = JaxIvfPq(D, **kw)
    x = _clustered(rng, 1400)
    ids = [f"d{i}" for i in range(1400)]
    j.add_batch(ids[:20], x[:20])               # below the auto-train threshold: overflow
    j.add_batch(ids[20:1300], x[20:1300])       # trains; full lists spill
    assert j.codebooks is not None and len(j._overflow) > 0
    t = IvfPqDeviceIndex(D, device="cpu", **kw)
    t.load_state(**_ivfpq_state(j))
    assert cell_map(t) == j._cell_to_id and not t.supports_exhaustive_mask
    q = np.concatenate([x[:3] + 0.05, _clustered(rng, 3)])

    def check(mask_ids=None):
        mt = mj = None
        if mask_ids is not None:
            mt, mj = t.compile_mask(mask_ids), j.compile_mask(mask_ids)
        got = t.search_batch(q, 10, mask=mt)
        assert_hits_match(got, j.search_batch(q, 10, mask=mj), TOL)
        if mask_ids is not None:
            assert all(i in mask_ids for row in got for i, _ in row)
        return got

    check()
    check({f"d{i}" for i in range(0, 1300, 3)})
    doomed = sorted({i for row in check() for i, _ in row})
    assert t.remove_batch(doomed) == j.remove_batch(doomed)
    for idx in (j, t):
        idx.add_batch(ids[1300:], x[1300:])     # encoded with the carried codebooks
    assert cell_map(t) == j._cell_to_id
    live = np.asarray(j.valid)
    np.testing.assert_array_equal(to_np(t.codes)[live], np.asarray(j.codes)[live])
    got = check()
    assert not {i for row in got for i, _ in row} & set(doomed)
    np.testing.assert_allclose(t.get_vector("d1350"), np.asarray(j.get_vector("d1350")),
                               rtol=0, atol=1e-5)
    tid, tv = t.get_all()
    jid, jv = j.get_all()
    assert tid == jid
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=1e-5)
    assert t.get_stats().memory_usage_mb == j.get_stats().memory_usage_mb


def test_ivf_pq_exact_fallback_until_codebooks_train(rng):
    """bf16 resident, trained on fewer rows than 2^nbits codewords: both stay
    on the exact IVF probe (the port's runs the bf16 probe kernel's plain
    version here)."""
    kw = dict(nlist=8, nprobe=3, initial_capacity=512)
    j = JaxIvfPq(D, **kw)
    x = _clustered(rng, 600)
    j.train(x[:100])
    j.add_batch([f"d{i}" for i in range(600)], x)
    assert j.centroids is not None and j.codebooks is None
    t = IvfPqDeviceIndex(D, device="cpu", **kw)
    t.load_state(**_ivfpq_state(j))
    assert t.codebooks is None and t.recip is not None
    q = np.concatenate([x[:3] + 0.05, _clustered(rng, 3)])
    assert_hits_match(t.search_batch(q, 10), j.search_batch(q, 10), TOL)
    with pytest.raises(ValueError, match="training vectors"):
        IvfPqDeviceIndex(D, nlist=8, resident="none", device="cpu").train(x[:100])


def test_ivf_pq_own_training_and_optimize(rng):
    for resident in ("bf16", "none"):
        t = IvfPqDeviceIndex(D, nlist=8, nprobe=8, initial_capacity=512, n_sub=8,
                             resident=resident, device="cpu")
        x = _clustered(rng, 1500, k=6, spread=0.2)
        ids = [f"d{i}" for i in range(1500)]
        t.add_batch(ids[:100], x[:100])
        assert not t.is_trained                  # below max(4 * nlist, 256)
        t.add_batch(ids[100:], x[100:])
        assert t.is_trained and t.codebooks is not None
        t.optimize()
        assert len(t._overflow) == 0
        got_ids, _ = t.get_all()
        assert sorted(got_ids) == sorted(ids)
        hits = t.search_batch(x[[0, 900]], 3)
        if resident == "bf16":      # rescored exactly: a stored row finds itself
            assert [row[0][0] for row in hits] == ["d0", "d900"]
        else:                       # ADC ranking: scores approximate the cosine
            xn = x / np.linalg.norm(x, axis=1, keepdims=True)
            for qi, row in zip((0, 900), hits):
                for i, s in row:
                    assert abs(s - float(xn[qi] @ xn[int(i[1:])])) < 0.05


# -- projected IVF ---------------------------------------------------------------


def _low_rank(rng, n, d=256, rank=48, noise=0.02):
    basis = np.linalg.qr(rng.standard_normal((d, rank)))[0].astype(np.float32)
    centres = rng.standard_normal((16, rank)).astype(np.float32)
    z = centres[rng.integers(0, 16, n)] + 0.3 * rng.standard_normal((n, rank)).astype(np.float32)
    return (z @ basis.T + noise * rng.standard_normal((n, d))).astype(np.float32)


def test_fit_projection_spans_the_same_subspace(rng):
    x = _low_rank(rng, 800)
    jp, je = j_fit_projection(jnp.asarray(x), 128)
    tp, te = _fit_projection(_t(x), 128)
    assert tp.shape == (256, 128)
    assert te == pytest.approx(float(je), rel=1e-4) and te > 0.99
    jp = np.asarray(jp, np.float64)
    tp = to_np(tp).astype(np.float64)
    np.testing.assert_allclose(tp @ tp.T, jp @ jp.T, rtol=0, atol=2e-3)
    np.testing.assert_allclose(tp.T @ tp, np.eye(128), rtol=0, atol=1e-4)


@pytest.mark.parametrize("jcls,tcls", [(JaxProj8, ProjectedInt8IvfIndex),
                                       (JaxProj4, ProjectedInt4IvfIndex)])
def test_projected_ivf_matches_jax_on_carried_state(rng, jcls, tcls):
    d = 256
    kw = dict(proj_dim=128, nlist=8, nprobe=3, initial_capacity=512)
    j = jcls(d, use_pallas="force", **kw)
    x = _low_rank(rng, 1300, d=d)
    ids = [f"d{i}" for i in range(1300)]
    j.add_batch(ids[:1200], x[:1200])
    assert j.proj_energy > 0.9 and j.centroids is not None
    t = tcls(d, device="cpu", **kw)
    st = _ivf_state(j)
    st.update(codes=np.asarray(j.codes), scales=np.asarray(j.scales),
              factor=np.asarray(j.factor), proj=np.asarray(j.proj), proj_energy=j.proj_energy)
    t.load_state(**st)
    assert t.dimension == d and t._dim == 128 and t.kind == j.kind
    q = np.concatenate([x[:3] + 0.02, _low_rank(rng, 3, d=d)])
    assert_hits_match(t.search_batch(q, 10), j.search_batch(q, 10), 3e-3)
    mask_ids = {f"d{i}" for i in range(0, 1200, 3)}
    got = t.search_batch(q, 10, mask=t.compile_mask(mask_ids))
    assert_hits_match(got, j.search_batch(q, 10, mask=j.compile_mask(mask_ids)), 3e-3)
    assert all(i in mask_ids for row in got for i, _ in row)
    for idx in (j, t):
        idx.remove_batch(ids[:30])
        idx.add_batch(ids[1200:], x[1200:])
    assert cell_map(t) == j._cell_to_id
    assert_hits_match(t.search_batch(q, 10), j.search_batch(q, 10), 3e-3)
    np.testing.assert_allclose(t.get_vector("d1250"), np.asarray(j.get_vector("d1250")),
                               rtol=0, atol=1e-4)
    assert t.get_stats().dimension == d and t.get_stats().extra["proj_dim"] == 128.0


@pytest.mark.parametrize("tcls", [ProjectedInt8IvfIndex, ProjectedInt4IvfIndex])
def test_projected_ivf_own_fit_and_optimize(rng, tcls):
    d = 256
    t = tcls(d, proj_dim=128, nlist=8, nprobe=8, initial_capacity=512, device="cpu")
    x = _low_rank(rng, 1200, d=d)
    ids = [f"d{i}" for i in range(1200)]
    t.add_batch(ids, x)
    assert t.proj.shape == (d, 128) and t.proj_energy > 0.99
    t.optimize()
    assert len(t._overflow) == 0 and sorted(t.get_all()[0]) == sorted(ids)
    hits = t.search_batch(x[[0, 700]], 3)
    assert [row[0][0] for row in hits] == ["d0", "d700"]
    with pytest.warns(RuntimeWarning, match="flat-spectrum"):
        tcls(d, proj_dim=128, nlist=8, device="cpu").add_batch(
            ids[:300], rng.standard_normal((300, d)).astype(np.float32))
    with pytest.raises(ValueError, match="min_energy"):
        tcls(d, proj_dim=128, nlist=8, min_energy=0.95, device="cpu").add_batch(
            ids[:300], rng.standard_normal((300, d)).astype(np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        tcls(d, proj_dim=100, device="cpu")


# -- the factory -----------------------------------------------------------------


@pytest.mark.parametrize("kind,cls", [
    ("binary", BinaryDeviceIndex), ("int8", Int8DeviceIndex), ("pq", PqDeviceIndex),
    ("ivf_pq", IvfPqDeviceIndex), ("ivf_int8_proj", ProjectedInt8IvfIndex),
    ("ivf_int4_proj", ProjectedInt4IvfIndex)])
def test_build_index_for_the_new_kinds(kind, cls):
    cfg = VectorDbConfig(vector_dimension=256)
    cfg.index.kind = kind
    cfg.index.nlist, cfg.index.nprobe, cfg.index.int8_rescore = 16, 4, 96
    cfg.index.rescore_ratio, cfg.index.pq_n_sub, cfg.index.pq_rescore_k = 0.2, 32, 128
    cfg.index.pq_resident, cfg.index.pq_residual, cfg.index.proj_dim = "int8", False, 128
    cfg.quantization.keep_vectors, cfg.quantization.prescan = False, "hamming"
    cfg.quantization.threshold = 0.25
    idx = build_index(cfg, device="cpu")
    assert type(idx) is cls and idx.kind == kind and idx.dimension == 256
    assert idx.device.type == "cpu"
    if kind == "binary":
        assert (idx.keep_vectors, idx.prescan, idx.threshold, idx.rescore_ratio,
                idx.hamming_impl) == (False, "hamming", 0.25, 0.2, "mxu")
    elif kind == "int8":
        assert idx.rescore == 96
    elif kind == "pq":
        assert (idx.n_sub, idx.nbits, idx.rescore_ratio) == (32, 8, 0.2)
    elif kind == "ivf_pq":
        assert (idx.n_sub, idx.resident, idx.residual, idx.rescore_k, idx.nlist,
                idx.nprobe) == (32, "int8", False, 128, 16, 4)
    else:
        assert (idx.proj_dim, idx.rescore, idx.nlist, idx._dim) == (128, 96, 16, 128)
    assert build_index(VectorDbConfig(vector_dimension=256), device="cpu").kind == "flat"

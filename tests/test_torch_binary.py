"""The port's binary kind (ops/hamming.py, index/binary.py) against the JAX
package, on the CPU.

The same numpy inputs (made from a seed) go through both. Packing is
bit-equal (the port's int32 words are the JAX uint32 words viewed as int32);
Hamming distances are integer-equal on every route, with the JAX Pallas
kernel run in interpret mode as tests/test_ops.py runs it; Hamming
selections agree id for id (ties go to the lower slot in both). The
asymmetric prescan sums a bf16 query against +-1 signs in f32 in another
order than XLA, so its scores agree within 1e-5 (relative above 1) and the
candidate sets may differ at the r-th prescan score: final results compare
with the near-tie guard there (tests/torch_parity.py
``assert_two_stage_match``). Rescored scores are f32 sums of exact bf16
products: 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from grape_vector_db_tpu import VectorDatabase as JaxDatabase
from grape_vector_db_tpu import VectorDbConfig as JaxConfig
from grape_vector_db_tpu.index.binary import BinaryDeviceIndex as JaxBinary
from grape_vector_db_tpu.ops import hamming as jh
from grape_vector_db_tpu.types import Condition as JaxCondition
from grape_vector_db_tpu.types import Document as JaxDocument
from grape_vector_db_tpu.types import Filter as JaxFilter
from grape_vector_db_tpu.types import SearchRequest as JaxSearchRequest
from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                       VectorDatabase, VectorDbConfig)
from grape_vector_db_tpu_torch.index import BinaryDeviceIndex
from grape_vector_db_tpu_torch.ops import hamming as th
from torch_parity import assert_hits_match, assert_topk_match, assert_two_stage_match, to_np

torch.set_num_threads(2)

D = 64
TOL = 1e-4          # rescored scores: f32 sums of exact bf16 products
ASYM_TOL = 1e-5     # asymmetric prescan scores, relative above 1
BOUNDARY_TOL = 1e-3  # near tie at the r-th prescan score


def _t(x):
    return torch.from_numpy(np.array(x))


def _codes_j(x, threshold=0.0):
    return jh.pack_bits(jnp.asarray(x), threshold)


@pytest.mark.parametrize("d", [17, 64, 96, 100])
@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_pack_bits_is_bit_equal(rng, d, threshold):
    x = rng.standard_normal((70, d)).astype(np.float32)
    x[0] = threshold          # on the threshold: not above it
    want = np.asarray(_codes_j(x, threshold)).view(np.int32)
    got = to_np(th.pack_bits(_t(x), threshold))
    assert got.dtype == np.int32 and got.shape == (70, th.words_per_vector(d))
    np.testing.assert_array_equal(got, want)
    signs = to_np(th._unpack_signs(th.pack_bits(_t(x), threshold)))
    np.testing.assert_array_equal(signs, np.asarray(jh._unpack_signs(_codes_j(x, threshold)),
                                                    np.float32))


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("impl", ["mxu", "popcount", "xla"])
def test_hamming_scores_match_on_every_route(rng, d, impl):
    """Integer-equal to the JAX XLA route and to the Pallas kernel run in
    interpret mode (C = 1024, a multiple of its 512-row block)."""
    a = _codes_j(rng.standard_normal((8, d)).astype(np.float32))
    b = _codes_j(rng.standard_normal((1024, d)).astype(np.float32))
    want = np.asarray(jh.hamming_scores(a, b, impl="xla"))
    np.testing.assert_array_equal(np.asarray(jh.hamming_scores(a, b, impl="pallas_interpret")),
                                  want)
    ta, tb = _t(np.asarray(a).view(np.int32)), _t(np.asarray(b).view(np.int32))
    got = th.hamming_scores(ta, tb, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(th.hamming_scores_ref(ta, tb)), want)


def test_hamming_plain_version_on_adversarial_words(rng):
    """All-zero, all-one and alternating words, W = 1 and 3, C not a
    multiple of 512: the plain version against numpy's popcount."""
    pats = np.array([0, -1, 0x55555555, -0x55555556, 0x0F0F0F0F, 1, -(2**31)], np.int64)
    for w in (1, 3):
        q = rng.choice(pats, (5, w)).astype(np.int32)
        c = rng.choice(pats, (777, w)).astype(np.int32)
        x = (q[:, None, :] ^ c[None, :, :]).view(np.uint32)
        want = np.unpackbits(x.view(np.uint8), axis=-1).reshape(5, 777, -1).sum(-1)
        np.testing.assert_array_equal(to_np(th.hamming_scores_ref(_t(q), _t(c))), want)


@pytest.mark.parametrize("k", [5, 40])
@pytest.mark.parametrize("chunk", [256, 1024])
def test_hamming_topk_id_for_id_with_lower_slot_ties(rng, k, chunk):
    """Rows drawn from 6 sign patterns: distances take few values, so ties
    are everywhere; the port's selection must give the reference's ids."""
    pats = rng.standard_normal((6, 32)).astype(np.float32)
    x = pats[rng.integers(0, 6, 1024)]
    valid = rng.random(1024) > 0.1
    codes = _codes_j(x)
    q = _codes_j(rng.standard_normal((7, 32)).astype(np.float32))
    jd, ji = jh.hamming_topk(q, codes, jnp.asarray(valid), k=k, chunk=chunk, impl="xla")
    for impl in ("mxu", "xla"):
        td, ti = th.hamming_topk(_t(np.asarray(q).view(np.int32)),
                                 _t(np.asarray(codes).view(np.int32)), _t(valid), k=k,
                                 chunk=chunk, impl=impl)
        np.testing.assert_array_equal(to_np(td), np.asarray(jd))
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji))


@pytest.mark.parametrize("chunk", [256, 1024])
def test_asym_topk_matches_with_near_tie_guard(rng, chunk):
    x = rng.standard_normal((1024, D)).astype(np.float32)
    valid = rng.random(1024) > 0.1
    q = rng.standard_normal((6, D)).astype(np.float32)
    codes = _codes_j(x)
    jv, ji = jh.asym_topk(jnp.asarray(q), codes, jnp.asarray(valid), k=40, chunk=chunk)
    tv, ti = th.asym_topk(_t(q), _t(np.asarray(codes).view(np.int32)), _t(valid), k=40,
                          chunk=chunk)
    assert_topk_match(tv, ti, np.asarray(jv), np.asarray(ji), ASYM_TOL)


# -- the index -----------------------------------------------------------------


def _both(**kw):
    kw.setdefault("initial_capacity", 64)
    return JaxBinary(D, **kw), BinaryDeviceIndex(D, device="cpu", **kw)


def _asym_scores(q, x):
    """numpy f64 asymmetric prescan scores [B, N]: bf16(q_unit) . sign(x)."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    qb = torch.from_numpy(qn.astype(np.float32)).to(torch.bfloat16).double().numpy()
    return qb @ np.where(x > 0, 1.0, -1.0).T


def _check_search(j, t, q, rows_of, k=10, mask_ids=None):
    """Hits of both indexes, with the candidate-boundary guard for asym.
    ``rows_of`` maps an id to its stored float row."""
    mj = mt = None
    if mask_ids is not None:
        mj, mt = j.compile_mask(mask_ids), t.compile_mask(mask_ids)
        np.testing.assert_array_equal(mt, mj)
    got, want = t.search_batch(q, k, mask=mt), j.search_batch(q, k, mask=mj)
    if t.prescan == "hamming":
        assert_hits_match(got, want, TOL)
        return got
    ids = [i for i in t._id_to_slot if mask_ids is None or i in mask_ids]
    pre = _asym_scores(q, np.stack([rows_of[i] for i in ids]))
    col = {i: c for c, i in enumerate(ids)}
    r = t._rescore_count(k)
    boundary = -np.sort(-pre, axis=1)[:, min(r, len(ids)) - 1]
    assert_two_stage_match(got, want, TOL, lambda row, i: pre[row, col[i]], boundary,
                           BOUNDARY_TOL)
    return got


@pytest.mark.parametrize("prescan,impl", [("asym", "mxu"), ("hamming", "mxu"),
                                          ("hamming", "popcount"), ("hamming", "xla")])
def test_index_matches_jax_across_growth_deletes_and_filters(rng, prescan, impl):
    j, t = _both(prescan=prescan, hamming_impl=impl, rescore_ratio=0.05)
    x = rng.standard_normal((1700, D)).astype(np.float32)
    ids = [f"d{i}" for i in range(1700)]
    rows = {}
    for idx in (j, t):
        idx.add_batch(ids[:600], x[:600])
        idx.add_batch(ids[600:1500], x[600:1500])        # grows 64 -> 2048
        idx.add_batch(["d3", "d4", "d3"], x[[1600, 1601, 1602]])   # overwrite, last wins
    rows.update({i: x[n] for n, i in enumerate(ids[:1500])})
    rows.update({"d3": x[1602], "d4": x[1601]})
    assert t.capacity == j.capacity == 2048
    assert t._slot_to_id == j._slot_to_id and t._high_water == j._high_water
    np.testing.assert_array_equal(to_np(t.codes), np.asarray(j.codes).view(np.int32))
    assert t._rescore_count(10) == j._rescore_count(10) == 128 < len(t)   # the prescan cuts
    q = np.concatenate([x[:4] + 0.1 * rng.standard_normal((4, D)).astype(np.float32),
                        rng.standard_normal((4, D)).astype(np.float32)])
    _check_search(j, t, q, rows)
    _check_search(j, t, q, rows, mask_ids={f"d{i}" for i in range(0, 1500, 7)})
    # deletes free slots; new ids reuse them
    doomed = [f"d{i}" for i in range(0, 40)] + ["nope"]
    assert t.remove_batch(doomed) == j.remove_batch(doomed) == 40
    for idx in (j, t):
        idx.add_batch(ids[1500:1530], x[1500:1530])
    rows.update({i: x[n] for n, i in enumerate(ids) if 1500 <= n < 1530})
    for i in doomed:
        rows.pop(i, None)
    assert t._free == j._free and t._slot_to_id == j._slot_to_id
    np.testing.assert_array_equal(to_np(t.valid), np.asarray(j.valid))
    got = _check_search(j, t, q, rows)
    assert not {i for row in got for i, _ in row} & set(doomed)
    stats = t.get_stats()
    assert stats.kind == "binary" and stats.extra == j.get_stats().extra


@pytest.mark.parametrize("prescan", ["asym", "hamming"])
def test_capacity_config_matches_jax(rng, prescan):
    """keep_vectors=False: codes only; the prescan ranking is the result and
    get_vector / get_all decode sign vectors."""
    j, t = _both(prescan=prescan, keep_vectors=False)
    x = rng.standard_normal((300, D)).astype(np.float32)
    ids = [f"d{i}" for i in range(300)]
    for idx in (j, t):
        idx.add_batch(ids, x)
        idx.remove_batch(ids[:5])
    assert t.vectors is None and t.norms is None and t.capacity == j.capacity == 512
    q = rng.standard_normal((5, D)).astype(np.float32)
    got, want = t.search_batch(q, 10), j.search_batch(q, 10)
    if prescan == "hamming":
        assert got == want          # exact integers, the same tie rule
    else:
        assert_hits_match(got, want, ASYM_TOL)
    np.testing.assert_array_equal(t.get_vector("d7"), np.asarray(j.get_vector("d7")))
    assert t.get_vector("d0") is None
    tid, tv = t.get_all()
    jid, jv = j.get_all()
    assert tid == jid
    np.testing.assert_array_equal(tv, np.asarray(jv))
    assert t.get_stats().memory_usage_mb == j.get_stats().memory_usage_mb
    with pytest.raises(ValueError, match="two-stage"):
        t.tune_rescore()


@pytest.mark.parametrize("impl", ["mxu", "popcount"])
def test_hamming_only_and_tune_rescore_match_jax(rng, impl):
    j, t = _both(prescan="hamming", hamming_impl=impl)
    x = rng.standard_normal((900, D)).astype(np.float32)
    ids = [f"d{i}" for i in range(900)]
    for idx in (j, t):
        idx.add_batch(ids, x)
    q = rng.standard_normal((6, D)).astype(np.float32)
    assert t.hamming_only_topk(q, 20) == j.hamming_only_topk(q, 20)
    for queries in (None, q):
        assert t.tune_rescore(queries, k=5, target_recall=0.9) == \
            j.tune_rescore(queries, k=5, target_recall=0.9)
        assert (t.rescore_ratio, t.max_rescore) == (j.rescore_ratio, j.max_rescore)


def test_load_state_carries_a_jax_binary_index(rng):
    j = JaxBinary(D, initial_capacity=64, keep_vectors=False, prescan="hamming")
    x = rng.standard_normal((100, D)).astype(np.float32)
    j.add_batch([f"d{i}" for i in range(100)], x)
    j.remove_batch(["d1"])
    t = BinaryDeviceIndex(D, initial_capacity=64, keep_vectors=False, prescan="hamming",
                          device="cpu")
    t.load_state(None, None, np.asarray(j.valid), j._slot_to_id, j._free, j._high_water,
                 codes=np.asarray(j.codes))
    q = rng.standard_normal((4, D)).astype(np.float32)
    assert t.search_batch(q, 7) == j.search_batch(q, 7)
    with pytest.raises(ValueError, match="exactly when"):
        t.load_state(np.zeros((128, D), np.float32), np.ones(128, np.float32),
                     np.asarray(j.valid), j._slot_to_id, j._free, j._high_water,
                     codes=np.asarray(j.codes))


def test_database_binary_matches_jax(rng):
    """VectorDatabase(kind="binary") end to end through engine/planner.py:
    batch search, a filtered search, delete, search again."""
    x = rng.standard_normal((1200, D)).astype(np.float32)
    q = np.concatenate([x[:3] + 0.1 * rng.standard_normal((3, D)).astype(np.float32),
                        rng.standard_normal((3, D)).astype(np.float32)])
    dbs = []
    for cfg_cls, db_cls, doc_cls, kw in ((JaxConfig, JaxDatabase, JaxDocument, {}),
                                         (VectorDbConfig, VectorDatabase, Document,
                                          {"device": "cpu"})):
        cfg = cfg_cls(vector_dimension=D)
        cfg.index.kind = "binary"
        db = db_cls(config=cfg, **kw)
        db.batch_add_documents([doc_cls(id=f"d{i}", content=f"doc {i}", vector=x[i],
                                        metadata={"bucket": i % 10}) for i in range(1200)])
        dbs.append(db)
    jdb, tdb = dbs
    idx = tdb.index
    assert idx.kind == "binary" and idx.prescan == "asym" and idx.hamming_impl == "mxu"
    assert idx._rescore_count(10) == 128 < len(idx)
    rows = {f"d{i}": x[i] for i in range(1200)}

    def rows_of(points):
        return [[(p.id, p.score) for p in r] for r in points]

    def check(got, want, qs, allowed=None):
        alive = [i for i in idx._id_to_slot if allowed is None or allowed(i)]
        pre = _asym_scores(qs, np.stack([rows[i] for i in alive]))
        col = {i: c for c, i in enumerate(alive)}
        boundary = -np.sort(-pre, axis=1)[:, min(128, len(alive)) - 1]
        assert_two_stage_match(got, want, 3e-3, lambda r, i: pre[r, col[i]], boundary,
                               BOUNDARY_TOL)

    check(rows_of(tdb.vector_search_batch(q, 10)), rows_of(jdb.vector_search_batch(q, 10)), q)
    for cond in (("bucket", "eq", 3), ("bucket", "lt", 9)):
        got = tdb.vector_search(SearchRequest(vector=q[0].tolist(), limit=10,
                                              filter=Filter(must=[Condition(*cond)])))
        want = jdb.vector_search(JaxSearchRequest(vector=q[0].tolist(), limit=10,
                                                  filter=JaxFilter(must=[JaxCondition(*cond)])))
        allowed = (lambda i: int(i[1:]) % 10 == 3) if cond[1] == "eq" else \
            (lambda i: int(i[1:]) % 10 < 9)
        check(rows_of([got]), rows_of([want]), q[:1], allowed)
        assert len(got) == 10 and all(allowed(p.id) for p in got)
    doomed = sorted({p.id for row in tdb.vector_search_batch(q, 10) for p in row})
    assert tdb.batch_delete_documents(doomed) == jdb.batch_delete_documents(doomed)
    for i in doomed:
        rows.pop(i)
    got = rows_of(tdb.vector_search_batch(q, 10))
    check(got, rows_of(jdb.vector_search_batch(q, 10)), q)
    assert not {i for row in got for i, _ in row} & set(doomed)
    assert tdb.health_check()["index_consistent"]
    jdb.close()
    tdb.close()

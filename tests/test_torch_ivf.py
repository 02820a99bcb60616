"""The port's IVF family (ivf, ivf_int8, ivf_int4) against the JAX package,
on the CPU.

Index level: the JAX index is built with ``use_pallas="force"`` (its Pallas
probe kernels run in interpret mode, tests/test_ivf.py), its state is carried
into the port with ``load_state`` (read back with ``np.asarray``), and both
must return the same hits: ids as sets with the near-tie guard, scores within
3e-3 (tests/torch_parity.py). k-means starts differ between the engines
(``jax.random`` cannot be reproduced), so the port's own training is checked
by its invariants instead, and k-means itself in tests/test_torch_ivf_ops.py.

Database level: ``VectorDatabase(device="cpu")`` against the JAX
``VectorDatabase`` at nprobe = nlist, where the partition no longer decides
the answer, including a filtered search the planner sends to the exact
device tier.
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu import VectorDatabase as JaxDatabase
from grape_vector_db_tpu import VectorDbConfig as JaxConfig
from grape_vector_db_tpu.index.ivf import IvfDeviceIndex as JaxIvf
from grape_vector_db_tpu.index.ivf_int4 import Int4IvfDeviceIndex as JaxInt4
from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex as JaxInt8
from grape_vector_db_tpu.types import Condition as JaxCondition
from grape_vector_db_tpu.types import Document as JaxDocument
from grape_vector_db_tpu.types import Filter as JaxFilter
from grape_vector_db_tpu.types import SearchRequest as JaxSearchRequest
from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                       VectorDatabase, VectorDbConfig)
from grape_vector_db_tpu_torch.db import build_index
from grape_vector_db_tpu_torch.index import (Int4IvfDeviceIndex, Int8IvfDeviceIndex,
                                             IvfDeviceIndex)
from torch_parity import assert_hits_match, cell_map, to_np

torch.set_num_threads(2)

D = 64
TOL = 3e-3
KINDS = {
    "ivf": (JaxIvf, IvfDeviceIndex, {}),
    "ivf_dot": (JaxIvf, IvfDeviceIndex, {"metric": "dot"}),
    "ivf_f32": (JaxIvf, IvfDeviceIndex, {"storage_dtype": "float32"}),
    # the plain gather probe: the reference's kernel is off for euclidean
    "ivf_euclidean": (JaxIvf, IvfDeviceIndex, {"metric": "euclidean"}),
    "ivf_int8": (JaxInt8, Int8IvfDeviceIndex, {"keep_bf16": True}),
    "ivf_int8_codes": (JaxInt8, Int8IvfDeviceIndex, {"keep_bf16": False}),
    "ivf_int4": (JaxInt4, Int4IvfDeviceIndex, {"keep_bf16": True}),
    "ivf_int4_codes": (JaxInt4, Int4IvfDeviceIndex, {"keep_bf16": False}),
}


def _clustered(rng, n, k=12, d=D, spread=0.3):
    centers = rng.standard_normal((k, d)).astype(np.float32)
    return (centers[rng.integers(0, k, n)]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _state(j) -> dict:
    """A JAX IVF index's state, read back as numpy, for ``load_state``."""
    o = j._overflow
    st = dict(centroids=np.asarray(j.centroids), norms=np.asarray(j.norms),
              valid=np.asarray(j.valid), list_cap=j.list_cap, next_pos=j._next_pos,
              free=j._free, id_to_cell=j._id_to_cell,
              vecs=None if j.vecs is None else np.asarray(j.vecs),
              recip=None if j.recip is None else np.asarray(j.recip),
              overflow=dict(vectors=np.asarray(o.vectors), norms=np.asarray(o.norms),
                            valid=np.asarray(o.valid), slot_to_id=o._slot_to_id,
                            free=o._free, high_water=o._high_water))
    if hasattr(j, "codes"):
        st.update(codes=np.asarray(j.codes), scales=np.asarray(j.scales),
                  factor=np.asarray(j.factor))
    return st


def _assert_same_bookkeeping(j, t):
    assert t.list_cap == j.list_cap
    assert t._id_to_cell == j._id_to_cell and cell_map(t) == j._cell_to_id
    assert t._free == j._free
    np.testing.assert_array_equal(t._next_pos, j._next_pos)
    assert t._overflow._id_to_slot == j._overflow._id_to_slot
    np.testing.assert_array_equal(to_np(t.valid), np.asarray(j.valid))


@pytest.mark.parametrize("kind", list(KINDS))
def test_index_matches_jax_on_carried_state(rng, kind):
    jcls, tcls, kw = KINDS[kind]
    x = _clustered(rng, 1400)
    ids = [f"d{i}" for i in range(len(x))]
    j = jcls(D, nlist=8, nprobe=3, initial_capacity=512, use_pallas="force", **kw)
    j.add_batch(ids[:20], x[:20])           # below the auto-train threshold: overflow
    j.add_batch(ids[20:1300], x[20:1300])   # trains, places; full lists spill
    assert j._use_pallas == (kind != "ivf_euclidean")
    assert j.list_cap == 128 and len(j._overflow) > 0
    t = tcls(D, nlist=8, nprobe=3, initial_capacity=512, device="cpu", **kw)
    t.load_state(**_state(j))
    _assert_same_bookkeeping(j, t)

    queries = np.concatenate([x[:3] + 0.05 * rng.standard_normal((3, D)).astype(np.float32),
                              _clustered(rng, 3)])
    k = 10

    def check(mask_ids=None):
        mt = mj = None
        if mask_ids is not None:
            mt, mj = t.compile_mask(mask_ids), j.compile_mask(mask_ids)
            np.testing.assert_array_equal(mt[0], mj[0])
            np.testing.assert_array_equal(mt[1], mj[1])
        assert_hits_match(t.search_batch(queries, k, mask=mt),
                          j.search_batch(queries, k, mask=mj), TOL)
        if mask_ids is not None:
            got = t.search_batch(queries, k, mask=mt, exhaustive=True)
            assert_hits_match(got, j.search_batch(queries, k, mask=mj, exhaustive=True), TOL)
            assert all(i in mask_ids for row in got for i, _ in row)

    check()
    allowed = {f"d{i}" for i in range(0, 1300, 3)}
    check(allowed)                                   # in-probe mask + compact tier
    t.compact_max_bytes = j.compact_max_bytes = 0
    check(allowed)                                   # streaming tier
    # deletes (top hits, and rows of the overflow region), then new rows
    doomed = sorted({i for row in t.search_batch(queries, k) for i, _ in row}
                    | set(list(t._overflow._id_to_slot)[:5]))
    assert t.remove_batch(doomed) == j.remove_batch(doomed) == len(doomed)
    check()
    check(allowed)
    for idx in (j, t):
        idx.add_batch(ids[1300:], x[1300:])
    _assert_same_bookkeeping(j, t)
    check()
    got = {i for row in t.search_batch(queries, k) for i, _ in row}
    assert not got & set(doomed)
    np.testing.assert_array_equal(t.get_vector("d1350"), np.asarray(j.get_vector("d1350")))
    tid, tv = t.get_all()
    jid, jv = j.get_all()
    assert tid == jid
    np.testing.assert_array_equal(tv, np.asarray(jv))


@pytest.mark.parametrize("kind", ["ivf", "ivf_int8", "ivf_int4"])
def test_own_training_optimize_and_invariants(rng, kind):
    """The port's own auto-train and optimize(): every id comes back, list
    capacities stay multiples of 128, and a stored row finds itself first."""
    _, tcls, kw = KINDS[kind]
    x = _clustered(rng, 1500, k=6, spread=0.2)   # few clusters: optimize regrows lists
    ids = [f"d{i}" for i in range(len(x))]
    t = tcls(D, nlist=8, nprobe=8, initial_capacity=512, device="cpu", **kw)
    t.add_batch(ids[:16], x[:16])
    assert not t.is_trained and t.search_batch(x[:2], 3)[0][0][0] == "d0"
    t.add_batch(ids[16:], x[16:])
    assert t.is_trained and len(t._overflow) > 0
    t.optimize()
    assert len(t._overflow) == 0 and t.list_cap % 128 == 0 and t.list_cap > 128
    got_ids, vecs = t.get_all()
    assert sorted(got_ids) == sorted(ids) and vecs.shape == (len(ids), D)
    probe = [0, 7, 500, 1499]
    for i, row in zip(probe, t.search_batch(x[probe], 3)):
        assert row[0][0] == f"d{i}"
        assert row[0][1] == pytest.approx(1.0, abs=TOL)
    assert t.get_stats().extra["overflow"] == 0.0
    assert 1 <= t.tune_nprobe(k=5, target_recall=0.9) <= 8


def _docs(cls, x, lo, hi):
    return [cls(id=f"d{i}", content=f"doc {i}", vector=x[i], metadata={"bucket": i % 10})
            for i in range(lo, hi)]


@pytest.mark.parametrize("kind", ["ivf", "ivf_int8", "ivf_int4"])
def test_database_matches_jax_at_full_probe(rng, kind):
    x = _clustered(rng, 1200)
    queries = np.concatenate([x[:4] + 0.05 * rng.standard_normal((4, D)).astype(np.float32),
                              _clustered(rng, 4)])
    dbs = []
    for cfg_cls, db_cls, doc_cls, kw in ((JaxConfig, JaxDatabase, JaxDocument, {}),
                                         (VectorDbConfig, VectorDatabase, Document,
                                          {"device": "cpu"})):
        cfg = cfg_cls(vector_dimension=D)
        cfg.index.kind = kind
        cfg.index.nlist = cfg.index.nprobe = 8
        cfg.query.filter_exact_max = 0     # low selectivity takes the exact device tier
        db = db_cls(config=cfg, **kw)
        db.batch_add_documents(_docs(doc_cls, x, 0, 1000))
        db.batch_add_documents(_docs(doc_cls, x, 1000, 1200))
        dbs.append(db)
    jdb, tdb = dbs
    assert tdb.index.kind == kind and tdb.index.is_trained

    def rows(points):
        return [(p.id, p.score) for p in points]

    def check_all(deleted=frozenset()):
        got = tdb.vector_search_batch(queries, 10)
        assert_hits_match([rows(r) for r in got],
                          [rows(r) for r in jdb.vector_search_batch(queries, 10)], TOL)
        for q in queries[:3]:
            for cond in (("bucket", "lt", 9), ("bucket", "eq", 3)):   # 90% and 10%
                got = tdb.vector_search(SearchRequest(
                    vector=q.tolist(), limit=10, filter=Filter(must=[Condition(*cond)])))
                want = jdb.vector_search(JaxSearchRequest(
                    vector=q.tolist(), limit=10, filter=JaxFilter(must=[JaxCondition(*cond)])))
                assert_hits_match([rows(got)], [rows(want)], TOL)
                assert len(got) == 10 and not {p.id for p in got} & deleted
            assert all(int(p.id[1:]) % 10 == 3 for p in got)

    check_all()
    doomed = sorted({p.id for row in tdb.vector_search_batch(queries, 10) for p in row})
    assert tdb.batch_delete_documents(doomed) == jdb.batch_delete_documents(doomed)
    check_all(frozenset(doomed))
    tdb.optimize()
    assert len(tdb.index) == 1200 - len(doomed) and tdb.health_check()["index_consistent"]
    got = tdb.vector_search_batch(queries, 10)
    assert_hits_match([rows(r) for r in got],
                      [rows(r) for r in jdb.vector_search_batch(queries, 10)], TOL)
    out = tdb.tune(target_recall=0.9, k=5)
    assert out["kind"] == kind and 1 <= out["nprobe"] <= 8
    hard = tdb.tune(target_recall=0.9, k=5, hard=True)
    assert hard["protocol"] == "held_out" and tdb.index.nprobe == hard["nprobe"]
    jdb.close()
    tdb.close()


def test_build_index_for_ivf_kinds():
    cfg = VectorDbConfig(vector_dimension=D)
    cfg.index.nlist, cfg.index.nprobe, cfg.index.int8_rescore = 32, 4, 96
    cfg.index.ivf_int8_keep_bf16 = False
    for kind, cls in (("ivf", IvfDeviceIndex), ("ivf_int8", Int8IvfDeviceIndex),
                      ("ivf_int4", Int4IvfDeviceIndex)):
        cfg.index.kind = kind
        idx = build_index(cfg, device="cpu")
        assert type(idx) is cls and idx.kind == kind
        assert (idx.nlist, idx.nprobe, idx.device.type) == (32, 4, "cpu")
        if kind != "ivf":
            assert idx.rescore == 96 and not idx.keep_bf16 and idx.vecs is None
    assert build_index(cfg, device="cpu").codes.shape == (32, 128, D // 2)

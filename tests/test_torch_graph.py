"""The port's graph search (kind="graph") against the JAX package, on the CPU.

Ops level, on the same seeded numpy inputs:
- ``top_k`` / ``take_topk`` / ``merge_topk`` against ``lax.top_k`` on
  tie-heavy inputs: positions equal (the lower position first on ties);
- ``gather_dots``'s plain version against JAX ``gather_dots`` on its XLA and
  interpret-mode Pallas routes, within 1e-5 of each entry's sum of |q_d v_d|
  (f32 sums in another order); out-of-range ids clamp, as the Pallas route
  clamps;
- the build's score through ``gather_dots`` equals the reference's form over
  materialized rows;
- ``build_knn_graph`` and ``beam_search``: on small-integer vectors with
  ``metric="dot"`` every sum is exact and ties abound, so neighbour arrays,
  ids and values must be equal; on Gaussian floats (cosine) the graph's
  recall and its agreement with JAX's are bounded, and beam results compare
  as id sets with the near-tie guard (3e-3, tests/torch_parity.py).

Index level: the JAX ``GraphDeviceIndex`` and the port's run the same
operations in lockstep; after each build of the JAX index its state crosses
into the port with ``load_state`` (k-means starts cannot match across
engines), and both must return the same hits. Database level:
``VectorDatabase(kind="graph", device="cpu")`` against a numpy oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from grape_vector_db_tpu.index.graph import GraphDeviceIndex as JaxGraph
from grape_vector_db_tpu.ops import gather_pallas as jgather
from grape_vector_db_tpu.ops import graph as jgraph
from grape_vector_db_tpu.ops import topk as jtopk
from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                       VectorDatabase, VectorDbConfig)
from grape_vector_db_tpu_torch.db import build_index
from grape_vector_db_tpu_torch.index import GraphDeviceIndex
from grape_vector_db_tpu_torch.ops import gather as tgather
from grape_vector_db_tpu_torch.ops import graph as tgraph
from grape_vector_db_tpu_torch.ops import topk as ttopk
from torch_parity import assert_hits_match, assert_topk_match, to_np

torch.set_num_threads(2)

TOL = 3e-3


# -- top-k tie rule ----------------------------------------------------------


def _tie_case(name: str) -> np.ndarray:
    g = np.random.default_rng(11)
    if name == "repeated":
        return g.integers(0, 4, (6, 40)).astype(np.float32)
    if name == "neginf_runs":
        x = g.integers(0, 3, (6, 40)).astype(np.float32)
        x[:, 5:25] = -np.inf
        x[2] = -np.inf
        return x
    if name == "all_equal":
        return np.full((3, 17), 0.5, np.float32)
    return np.where(g.random((5, 33)) < 0.5, -np.inf, 1.0).astype(np.float32)   # mixed


@pytest.mark.parametrize("case", ["repeated", "neginf_runs", "all_equal", "mixed"])
def test_top_k_breaks_ties_as_lax_top_k(case):
    x = _tie_case(case)
    idx = np.random.default_rng(12).permutation(x.size).reshape(x.shape).astype(np.int32)
    half = x.shape[1] // 2
    for k in (1, 7, x.shape[1]):
        jv, jp = lax.top_k(jnp.asarray(x), k)
        tv, tp = ttopk.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jv, ji = jtopk.take_topk(jnp.asarray(x), jnp.asarray(idx), k)
        tv, ti = ttopk.take_topk(torch.from_numpy(x), torch.from_numpy(idx), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        jv, ji = jtopk.merge_topk(jnp.asarray(x[:, :half]), jnp.asarray(idx[:, :half]),
                                  jnp.asarray(x[:, half:]), jnp.asarray(idx[:, half:]), k)
        tv, ti = ttopk.merge_topk(*(torch.from_numpy(a) for a in (
            x[:, :half], idx[:, :half], x[:, half:], idx[:, half:])), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- gather_dots ---------------------------------------------------------------


def _gather_case(b, c, d, n, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, d)).astype(np.float32),
            g.standard_normal((n, d)).astype(np.float32),
            g.integers(0, n, (b, c)).astype(np.int32))


def _abs_sums(q, v, ids, dtype):
    """Per entry, the sum of |q_d v_d| over the rounded operands."""
    qr = torch.from_numpy(q).to(dtype).float().numpy()
    vr = torch.from_numpy(v).to(dtype).float().numpy()
    rows = vr[np.clip(ids, 0, len(v) - 1)]
    return np.einsum("bd,bcd->bc", np.abs(qr), np.abs(rows))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,c,d", [(8, 24, 128), (5, 37, 100)])
def test_gather_dots_plain_matches_jax(impl, dtype, b, c, d):
    q, v, ids = _gather_case(b, c, d, n=300)
    tdt = getattr(torch, dtype)
    want = np.asarray(jgather.gather_dots(jnp.asarray(q), jnp.asarray(v).astype(dtype),
                                          jnp.asarray(ids), impl=impl))
    before = tgather.LAUNCHES["gather_dots"]
    got = tgather.gather_dots(torch.from_numpy(q), torch.from_numpy(v).to(tdt),
                              torch.from_numpy(ids), impl=impl)
    assert tgather.LAUNCHES["gather_dots"] == before     # CPU tensors: no launch
    assert got.dtype == torch.float32 and got.shape == (b, c)
    bad = np.abs(got.numpy() - want) > 1e-5 * _abs_sums(q, v, ids, tdt) + 1e-30
    assert not bad.any(), (got.numpy()[bad][:5], want[bad][:5])


def test_gather_dots_clamps_out_of_range_ids_as_the_pallas_route():
    """Ids below 0 and at or above N read row 0 and row N-1, as the Pallas
    kernel clamps (the reference's XLA route wraps -1 to the last row)."""
    q, v, _ = _gather_case(3, 1, 64, n=50, seed=3)
    ids = np.array([[0, -1, 5, 50], [49, -7, 60, -1], [1, 2, 3, 1 << 20]], np.int32)
    got = tgather.gather_dots(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(ids))
    want = np.asarray(jgather.gather_dots(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ids),
                                          impl="pallas_interpret"))
    clamped = tgather.gather_dots(torch.from_numpy(q), torch.from_numpy(v),
                                  torch.from_numpy(np.clip(ids, 0, 49)))
    assert torch.equal(got, clamped)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        tgather.gather_dots(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(ids),
                            impl="mosaic")
    assert tgather.pallas_gather_supported(768, torch.bfloat16)


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_refine_score_forms_are_equal(metric, dtype):
    """The build's score through gather_dots equals the reference's form
    over materialized candidate rows (port and JAX), term for term."""
    g = np.random.default_rng(4)
    v = g.standard_normal((200, 32)).astype(np.float32)
    cand = g.integers(0, 200, (40, 24)).astype(np.int32)
    vt = torch.from_numpy(v).to(getattr(torch, dtype))
    norms = torch.linalg.vector_norm(vt.float(), dim=1)
    q = tgraph.prepare_queries(vt[:40].float(), metric)
    ct = torch.from_numpy(cand).long()
    two = tgraph._dots_to_scores(q, tgather.gather_dots(q, vt, torch.from_numpy(cand)),
                                 norms[ct], metric)
    one = tgraph._pairwise_scores(q, vt[ct], norms[ct], metric)
    assert torch.equal(one, two)
    jv = jnp.asarray(v).astype(dtype)
    ref = np.asarray(jgraph._pairwise_scores(jnp.asarray(q.numpy()), jv[jnp.asarray(cand)],
                                             jnp.asarray(norms.numpy())[jnp.asarray(cand)],
                                             metric))
    np.testing.assert_allclose(two.numpy(), ref, rtol=1e-5, atol=1e-4)


# -- build and beam --------------------------------------------------------------


def _record_ids(monkeypatch):
    """Wrap the graph module's gather_dots; returns the list of (n, ids)."""
    seen = []
    inner = tgraph.gather_dots

    def spy(q, vectors, ids, impl="xla"):
        seen.append((vectors.shape[0], ids.clone()))
        return inner(q, vectors, ids, impl=impl)

    monkeypatch.setattr(tgraph, "gather_dots", spy)
    return seen


def _assert_in_range(seen):
    assert seen
    for n, ids in seen:
        assert ids.dtype == torch.int32
        assert int(ids.min()) >= 0 and int(ids.max()) < n, "an out-of-range id reached gather"


def _integer_corpus(n=300, d=16, seed=5):
    g = np.random.default_rng(seed)
    v = g.integers(-2, 3, (n, d)).astype(np.float32)
    v[40:45] = v[7]                      # duplicate rows: equal scores
    valid = g.random(n) >= 0.1
    return v, valid


def _jax_build(v, valid, metric, **kw):
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    return np.asarray(jgraph.build_knn_graph(jnp.asarray(v), jnp.asarray(norms),
                                             jnp.asarray(valid), metric=metric, **kw))


def _port_build(v, valid, metric, **kw):
    vt = torch.from_numpy(v)
    return tgraph.build_knn_graph(vt, torch.linalg.vector_norm(vt, dim=1),
                                  torch.from_numpy(valid), metric=metric, **kw)


@pytest.mark.parametrize("chunk", [64, 2048])
def test_build_knn_graph_integer_dot_equals_jax(monkeypatch, chunk):
    """Exact sums, ties everywhere, invalid rows, duplicate rows, a ragged
    tail chunk (300 = 4 x 64 + 44): the neighbour arrays are equal."""
    v, valid = _integer_corpus()
    kw = dict(m=8, rounds=4, nn_sample=4, chunk=chunk, seed=3)
    seen = _record_ids(monkeypatch)
    got = _port_build(v, valid, "dot", **kw)
    _assert_in_range(seen)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax_build(v, valid, "dot", **kw))


def test_build_knn_graph_cosine_recall_and_agreement(rng):
    """The production build (degree 2m, join sample 8, 12 rounds) on
    Gaussian data, as tests/test_graph.py: recall of the true m-NN >= 0.9,
    and the neighbour sets agree with JAX's on >= 0.98 of entries."""
    n, d, m = 1000, 32, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.ones(n, bool)
    kw = dict(m=2 * m, rounds=12, nn_sample=8)
    got = _port_build(v, valid, "cosine", **kw)
    want = _jax_build(v, valid, "cosine", **kw)
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    s = vn @ vn.T
    np.fill_diagonal(s, -np.inf)
    oracle = np.argsort(-s, axis=1)[:, :m]
    recall = np.mean([len(set(got[i]) & set(oracle[i])) / m for i in range(n)])
    assert recall >= 0.9, recall
    agree = np.mean([len(set(got[i]) & set(want[i])) / (2 * m) for i in range(n)])
    assert agree >= 0.98, agree


def _beam_inputs(case):
    """(vectors, valid, neighbours from the JAX build, entries, metric, beam kwargs)."""
    if case == "cosine":
        g = np.random.default_rng(6)
        v = g.standard_normal((600, 24)).astype(np.float32)
        valid = np.ones(600, bool)
        valid[::17] = False
        metric, bkw = "cosine", dict(k=10, pool=64, expand=8, iters=8)
        entries = np.arange(0, 600, 40, dtype=np.int32)
    else:
        v, valid = _integer_corpus()
        metric = "dot"
        if case == "int_dot":
            bkw = dict(k=10, pool=32, expand=8, iters=6)
            entries = np.arange(0, 300, 19, dtype=np.int32)
        else:
            # "padding_wrap": 3 entries and k 6 make a pool of 6 with 3
            # padding slots (-1); the first expansion (6 wide) picks them and
            # reads neighbours[-1]
            bkw = dict(k=6, pool=16, expand=8, iters=3)
            entries = np.array([3, 100, 200], np.int32)
    nb = _jax_build(v, valid, metric, m=8, rounds=4, nn_sample=4)
    return v, valid, nb, entries, metric, bkw


@pytest.mark.parametrize("case", ["int_dot", "padding_wrap", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_search_on_a_jax_graph(monkeypatch, case, dtype):
    v, valid, nb, entries, metric, bkw = _beam_inputs(case)
    g = np.random.default_rng(7)
    q = (v[g.integers(0, len(v), 12)] + g.integers(-1, 2, (12, v.shape[1]))).astype(np.float32)
    vj = jnp.asarray(v).astype(dtype)
    norms_j = jnp.linalg.norm(vj.astype(jnp.float32), axis=1)
    jv, ji = jgraph.beam_search(jnp.asarray(q), vj, norms_j, jnp.asarray(valid),
                                jnp.asarray(entries), jnp.asarray(nb), metric=metric, **bkw)
    vt = torch.from_numpy(v).to(getattr(torch, dtype))
    seen = _record_ids(monkeypatch)
    tv, ti = tgraph.beam_search(torch.from_numpy(q), vt, torch.linalg.vector_norm(
        vt.float(), dim=1), torch.from_numpy(valid), torch.from_numpy(entries),
        torch.from_numpy(nb), metric=metric, **bkw)
    _assert_in_range(seen)
    assert ti.dtype == torch.int32 and tv.shape == (12, bkw["k"])
    if case == "cosine":
        assert_topk_match(tv, ti, jv, ji, TOL)
    else:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "padding_wrap":
        # every query's first expansion holds the last row's neighbour list
        first = seen[1][1].reshape(12, -1, 8)
        assert bool((first == torch.from_numpy(nb[-1])).all(-1).any(-1).all())


# -- the index -------------------------------------------------------------------


def _flat_state(f) -> dict:
    return dict(vectors=np.asarray(f.vectors), norms=np.asarray(f.norms),
                valid=np.asarray(f.valid), slot_to_id=f._slot_to_id, free=f._free,
                high_water=f._high_water)


def _graph_state(j) -> dict:
    """A JAX graph index's state, read back as numpy, for ``load_state``."""
    def arr(x):
        return None if x is None else np.asarray(x)

    return dict(graph_store=_flat_state(j._graph_store), fresh=_flat_state(j._fresh),
                neighbors=arr(j.neighbors), entries=arr(j.entries),
                centroids=arr(j.centroids), reps=arr(j.reps), graph_n=j._graph_n,
                nb_cap=getattr(j, "_nb_cap", 0), builds=j.builds)


def _scenario(name, g):
    """(constructor kwargs, operations, queries): the cases of tests/test_graph.py."""
    d = 16
    v = g.standard_normal((600, d)).astype(np.float32)
    ids = [f"p{i}" for i in range(600)]
    kw = dict(storage_dtype="float32", m=8, ef_search=64)
    if name == "fresh_region":
        ops = [("add", ids[:500], v[:500]), ("add", ids[500:520], v[500:520])]
        qi = [510, 100, 3]
    elif name == "rebuild":
        kw["rebuild_ratio"] = 0.1
        ops = [("add", ids[:300], v[:300]), ("add", ids[300:400], v[300:400])]
        qi = [350, 10]
    elif name == "delete":
        ops = [("add", ids[:400], v[:400]), ("optimize",), ("remove", ["p7", "p9"])]
        qi = [7, 9, 20]
    elif name == "upsert":
        newv = g.standard_normal((2, d)).astype(np.float32)
        v[598:600] = newv
        ops = [("add", ids[:300], v[:300]), ("optimize",), ("add", ["p5", "p6"], newv),
               ("optimize",)]
        qi = [598, 599, 40]
    elif name == "tiny":
        kw.update(m=4, ef_search=16, n_entries=4, expand=8)
        ops = [("add", ids[:6], v[:6]), ("optimize",)]
        qi = [0, 5]
    else:   # "slot_zero"
        kw.update(n_entries=16)
        v = g.standard_normal((600, 24)).astype(np.float32)
        ops = [("add", ids[:500], v[:500]), ("optimize",)]
        qi = [0, 1]
    q = np.concatenate([v[qi], g.standard_normal((4, v.shape[1])).astype(np.float32)])
    return v.shape[1], kw, ops, q


@pytest.mark.parametrize("name", ["fresh_region", "rebuild", "delete", "upsert", "tiny",
                                  "slot_zero"])
def test_graph_index_matches_jax_in_lockstep(name):
    g = np.random.default_rng(8)
    d, kw, ops, q = _scenario(name, g)
    j = JaxGraph(d, **kw)
    t = GraphDeviceIndex(d, **kw, device="cpu")
    for op in ops:
        for idx in (j, t):
            if op[0] == "add":
                idx.add_batch(op[1], op[2])
            elif op[0] == "remove":
                assert idx.remove_batch(op[1]) == len(op[1])
            else:
                idx.optimize()
        assert t.builds == j.builds and len(t) == len(j) and t.is_built == j.is_built
        assert t.get_stats().extra == j.get_stats().extra
        if t.is_built:
            # the port's own graph (f32 sums in another order) against JAX's,
            # then JAX's state (k-means starts differ) for the searches
            tn, jn = to_np(t.neighbors), np.asarray(j.neighbors)
            assert tn.shape == jn.shape
            agree = np.mean([len(set(a) & set(b)) / len(set(a) | set(b))
                             for a, b in zip(tn, jn)])
            assert agree >= 0.98, agree
            t.load_state(**_graph_state(j))
        for k in (1, 5):
            assert_hits_match(t.search_batch(q, k), j.search_batch(q, k), TOL)
    ids_t, vecs_t = t.get_all()
    ids_j, vecs_j = j.get_all()
    assert ids_t == ids_j
    np.testing.assert_array_equal(vecs_t, vecs_j)
    top = t.search_batch(q[:1], 1)[0]
    assert top and top[0][0] == j.search_batch(q[:1], 1)[0][0][0]


def test_graph_index_own_build_equals_jax_on_integer_dot():
    """Where no k-means runs (n_entries >= live rows) the port's own build,
    entries and searches equal JAX's exactly on integer data, through the
    first build, the fresh region, a delete and a rebuild."""
    v, _ = _integer_corpus(n=400)
    ids = [f"r{i}" for i in range(400)]
    q = v[[3, 50, 120, 399]] + 1.0
    kw = dict(metric="dot", storage_dtype="float32", m=4, ef_search=32, n_entries=512)
    j = JaxGraph(16, **kw)
    t = GraphDeviceIndex(16, **kw, device="cpu")
    for step in ("first", "fresh", "delete", "rebuild"):
        for idx in (j, t):
            if step == "first":
                idx.add_batch(ids[:300], v[:300])
            elif step == "fresh":
                idx.add_batch(ids[300:340], v[300:340])
            elif step == "delete":
                idx.remove_batch(ids[::5])
            else:
                idx.add_batch(ids[340:], v[340:])
                idx.optimize()
        assert t.builds == j.builds
        np.testing.assert_array_equal(to_np(t.neighbors), np.asarray(j.neighbors))
        np.testing.assert_array_equal(to_np(t.entries), np.asarray(j.entries))
        # the flat fresh region may order exact ties differently: tolerance 0
        assert_hits_match(t.search_batch(q, 8), j.search_batch(q, 8), 0.0)


# -- the database ------------------------------------------------------------------


def test_build_index_graph_maps_the_config():
    cfg = VectorDbConfig(vector_dimension=32)
    cfg.index.kind = "graph"
    idx = build_index(cfg, device="cpu")
    assert isinstance(idx, GraphDeviceIndex) and not idx.supports_mask
    assert (idx.degree, idx.pool, idx.build_rounds, idx.search_iters) == (32, 128, 12, 16)
    assert idx._graph_store.storage_dtype == torch.bfloat16


def test_database_graph_kind_against_the_oracle():
    d, n = 32, 1200
    g = np.random.default_rng(9)
    centres = g.standard_normal((24, d)).astype(np.float32)
    x = (centres[g.integers(0, 24, n)] + 0.3 * g.standard_normal((n, d))).astype(np.float32)
    cfg = VectorDbConfig(vector_dimension=d)
    cfg.index.kind = "graph"
    db = VectorDatabase(config=cfg, device="cpu")
    for off in range(0, n, 200):
        db.batch_add_documents([Document(id=f"doc{i}", content=f"doc {i}", vector=x[i],
                                         metadata={"g": i % 10}) for i in range(off, off + 200)])
    db.optimize()
    stats = db.index.get_stats()
    assert stats.extra["builds"] >= 3 and stats.extra["fresh"] == 0 and stats.point_count == n
    q = x[:16] + 0.1 * g.standard_normal((16, d)).astype(np.float32)
    xr = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    oracle = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        xr / np.linalg.norm(xr, axis=1, keepdims=True)).T
    hits = db.vector_search_batch(q, 10)
    found = 0
    for r, row in enumerate(hits):
        got = {int(p.id[3:]): p.score for p in row}
        assert len(got) == len(row) == 10
        for i, s in got.items():
            assert abs(s - oracle[r, i]) <= TOL, (i, s, oracle[r, i])
        found += len(set(got) & set(np.argsort(-oracle[r])[:10].tolist()))
    assert found / 160 >= 0.9, found / 160
    filt = Filter(must=[Condition("g", "eq", 3)])
    for r in range(4):
        row = db.vector_search(SearchRequest(vector=q[r].tolist(), limit=5, filter=filt))
        assert row and all(int(p.id[3:]) % 10 == 3 for p in row)
    gone = {p.id for row in hits[:4] for p in row[:3]}
    assert db.batch_delete_documents(sorted(gone)) == len(gone)
    after = db.vector_search_batch(q[:4], 10)
    assert all(p.id not in gone for row in after for p in row)
    assert all(len(row) == 10 for row in after)
    db.close()

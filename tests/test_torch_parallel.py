"""The port's mesh-sharded indexes (``grape_vector_db_tpu_torch.parallel``)
against the JAX package's, on the CPU: the counterpart of
tests/test_parallel.py, case by case.

The JAX side runs on the repo's 8-device virtual CPU mesh (tests/conftest.py);
the port's mesh repeats the one CPU 8 times (``make_mesh(n_shards=8,
devices=[cpu])``). Both take the same numpy inputs from a seed. Placements
(the slot of every id, per-shard counts, free lists) must be equal; answers
compare as id sets with the near-tie guard and scores within 1e-5 in f32
storage, 3e-3 in bf16 (tests/torch_parity.py). k-means starts differ across
engines, so an IVF index of the port takes the JAX index's centroids before
its first write (it then places every row itself), or its whole state with
``load_state``. Where the JAX test runs Pallas, it runs in interpret mode, as
the reference's own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from grape_vector_db_tpu.parallel import make_mesh as jax_make_mesh
from grape_vector_db_tpu.parallel import mesh as jmesh
from grape_vector_db_tpu_torch.index import FlatDeviceIndex
from grape_vector_db_tpu_torch.ops import ivf as tivf
from grape_vector_db_tpu_torch.ops import segmax as tseg
from grape_vector_db_tpu_torch.parallel import mesh as tmesh
from torch_parity import assert_hits_match, assert_topk_match, to_np

torch.set_num_threads(2)

CPU = torch.device("cpu")
F32 = 1e-5


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(), tmesh.make_mesh(n_shards=8, devices=[CPU])


def _queries(rng, vecs, n, noise=0.001):
    return vecs[:n] + noise * rng.standard_normal((n, vecs.shape[1])).astype(np.float32)


def _same_flat_layout(t, j):
    assert t._id_to_slot == j._id_to_slot
    assert t._free == j._free and t._next_in_shard == j._next_in_shard
    assert t.get_stats().extra == j.get_stats().extra
    np.testing.assert_array_equal(np.asarray(t.valid), np.asarray(j.valid))


def _ivf_pair(jcls, tcls, meshes, dim, ids, vecs, jax_kw=None, **kw):
    """A JAX sharded IVF index fed ``ids``/``vecs`` in one batch (it trains
    on them), and the port's with the JAX centroids set first, fed the same.
    ``jax_kw`` goes to the JAX index only."""
    jm, tm = meshes
    j = jcls(dim, mesh=jm, **kw, **(jax_kw or {}))
    j.add_batch(ids, vecs)
    t = tcls(dim, mesh=tm, **kw)
    t.centroids = torch.from_numpy(np.array(j.centroids))
    t.add_batch(ids, vecs)
    assert t.list_cap == j.list_cap and t.n_shards == j.n_shards == 8
    assert t._id_to_cell == j._id_to_cell and t._free == j._free
    np.testing.assert_array_equal(t._next_pos, j._next_pos)
    assert t._overflow._id_to_slot == j._overflow._id_to_slot
    np.testing.assert_array_equal(np.asarray(t.valid), np.asarray(j.valid))
    return j, t


def test_mesh_has_8_devices(meshes):
    jm, tm = meshes
    assert tm.shape["shard"] == jm.shape["shard"] == 8
    assert tm.axis_names == jm.axis_names == ("shard",)
    assert all(d == CPU for d in tm.devices.flat)
    # devices repeat in turn; JAX truncates (a deliberate difference)
    two = tmesh.make_mesh(n_shards=5, devices=["cpu:0", "meta"])
    assert [d.type for d in two.devices.flat] == ["cpu", "meta", "cpu", "meta", "cpu"]
    m2 = tmesh.make_mesh_2d(2, devices=[CPU] * 8)
    assert m2.shape == {"replica": 2, "shard": 4} == dict(jmesh.make_mesh_2d(2).shape)
    with pytest.raises(ValueError):
        tmesh.make_mesh_2d(3, devices=[CPU] * 8)


def test_sharded_matches_single_device(rng, meshes):
    d, n, k = 32, 700, 10
    ids = [f"doc-{i}" for i in range(n)]
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    j = jmesh.ShardedFlatIndex(d, mesh=meshes[0], storage_dtype="float32", shard_capacity=128)
    t = tmesh.ShardedFlatIndex(d, mesh=meshes[1], storage_dtype="float32", shard_capacity=128)
    single = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=1024, device="cpu")
    for idx in (j, t, single):
        idx.add_batch(ids, vecs)
    assert len(t) == n
    _same_flat_layout(t, j)
    qs = rng.standard_normal((5, d)).astype(np.float32)
    got = t.search_batch(qs, k)
    assert_hits_match(got, j.search_batch(qs, k), F32)
    assert_hits_match(got, single.search_batch(qs, k), F32)


def test_sharded_balanced_placement(rng, meshes):
    j = jmesh.ShardedFlatIndex(16, mesh=meshes[0], storage_dtype="float32", shard_capacity=64)
    t = tmesh.ShardedFlatIndex(16, mesh=meshes[1], storage_dtype="float32", shard_capacity=64)
    ids = [f"x-{i}" for i in range(80)]
    vecs = rng.standard_normal((80, 16)).astype(np.float32)
    j.add_batch(ids, vecs)
    t.add_batch(ids, vecs)
    counts = [t.get_stats().extra[f"shard_{i}_points"] for i in range(8)]
    assert max(counts) - min(counts) <= 1
    _same_flat_layout(t, j)
    st, sj = t.get_stats(), j.get_stats()
    assert (st.point_count, st.capacity, st.kind) == (sj.point_count, sj.capacity, sj.kind)
    assert st.memory_usage_mb == pytest.approx(sj.memory_usage_mb)


def test_sharded_delete_and_reuse(rng, meshes):
    j = jmesh.ShardedFlatIndex(16, mesh=meshes[0], storage_dtype="float32", shard_capacity=32)
    t = tmesh.ShardedFlatIndex(16, mesh=meshes[1], storage_dtype="float32", shard_capacity=32)
    ids = [f"x-{i}" for i in range(50)]
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    more = rng.standard_normal((25, 16)).astype(np.float32)
    for idx in (j, t):
        idx.add_batch(ids, vecs)
        assert idx.remove_batch(ids[:25]) == 25
    assert len(t) == 25
    _same_flat_layout(t, j)
    hits = t.search_batch(vecs[30:31], 5)
    assert hits[0][0][0] == "x-30" and not {h[0] for h in hits[0]} & set(ids[:25])
    assert_hits_match(hits, j.search_batch(vecs[30:31], 5), F32)
    for idx in (j, t):   # freed slots are reused
        idx.add_batch([f"y-{i}" for i in range(25)], more)
    assert len(t) == 50
    _same_flat_layout(t, j)
    assert_hits_match(t.search_batch(more[:4], 6), j.search_batch(more[:4], 6), F32)


def test_redistribute_to_smaller_mesh(rng, meshes):
    j = jmesh.ShardedFlatIndex(16, mesh=meshes[0], storage_dtype="float32", shard_capacity=64)
    t = tmesh.ShardedFlatIndex(16, mesh=meshes[1], storage_dtype="float32", shard_capacity=64)
    ids = [f"x-{i}" for i in range(100)]
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    j.add_batch(ids, vecs)
    t.add_batch(ids, vecs)
    j.redistribute(jax_make_mesh(n_shards=4), shard_capacity=64)
    t.redistribute(tmesh.make_mesh(n_shards=4, devices=[CPU]), shard_capacity=64)
    assert t.n_shards == 4 and len(t) == 100
    _same_flat_layout(t, j)
    hits = t.search_batch(vecs[7:8], 3)
    assert hits[0][0][0] == "x-7"
    assert_hits_match(hits, j.search_batch(vecs[7:8], 3), F32)
    np.testing.assert_array_equal(t.get_all()[1], j.get_all()[1])


def test_2d_mesh_replica_sharded(rng):
    """(replica=2, shard=4): the batch splits over the replicas, the corpus
    over 4 shards a replica; the raw function against JAX's and the
    single-device exact index."""
    mesh2 = jmesh.make_mesh_2d(n_replicas=2)
    tm2 = tmesh.make_mesh_2d(2, n_shards=4, devices=[CPU])
    d, per_shard, b, k = 32, 64, 16, 5
    n = 4 * per_shard
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.linalg.norm(vecs, axis=1).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[::7] = False
    qs = rng.standard_normal((b, d)).astype(np.float32)
    jv, ji = jmesh.replicated_sharded_topk(
        jax.device_put(jnp.asarray(qs), NamedSharding(mesh2, P("replica", None))),
        jax.device_put(jnp.asarray(vecs), NamedSharding(mesh2, P("shard", None))),
        jax.device_put(jnp.asarray(norms), NamedSharding(mesh2, P("shard"))),
        jax.device_put(jnp.asarray(valid), NamedSharding(mesh2, P("shard"))),
        k=k, metric="cosine", chunk=per_shard, mesh=mesh2)
    tv, ti = tmesh.replicated_sharded_topk(
        torch.from_numpy(qs), torch.from_numpy(vecs), torch.from_numpy(norms),
        torch.from_numpy(valid), k=k, metric="cosine", chunk=per_shard, mesh=tm2)
    assert_topk_match(tv, ti, jv, ji, F32)
    single = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=256, device="cpu")
    single.add_batch([str(i) for i in range(n)], vecs)
    single.remove_batch([str(i) for i in range(0, n, 7)])
    want = single.search_batch(qs, k)
    for row, w in zip(to_np(ti), want):
        assert [str(i) for i in row] == [h[0] for h in w]


# -- sharded IVF ------------------------------------------------------------------


def test_sharded_ivf_matches_single_device_full_probe(rng, meshes):
    """nprobe == nlist: exhaustive, so equal to the flat oracle and to JAX."""
    dim, n, k = 24, 800, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=1024, device="cpu")
    flat.add_batch(ids, vecs)
    j, t = _ivf_pair(jmesh.ShardedIvfIndex, tmesh.ShardedIvfIndex, meshes, dim, ids, vecs,
                     storage_dtype="float32", nlist=8, nprobe=8, initial_capacity=2048)
    assert len(t._overflow) == 0
    queries = _queries(rng, vecs, 16)
    got = t.search_batch(queries, k)
    assert_hits_match(got, j.search_batch(queries, k), F32)
    for w, g in zip(flat.search_batch(queries, k), got):
        assert [x[0] for x in w] == [x[0] for x in g]


def test_sharded_ivf_recall_with_partial_probe(rng, meshes):
    dim, k = 24, 10
    centers = rng.standard_normal((16, dim)).astype(np.float32) * 4
    rows = np.concatenate([c + 0.3 * rng.standard_normal((200, dim)).astype(np.float32)
                           for c in centers])
    ids = [f"d{i}" for i in range(len(rows))]
    j, t = _ivf_pair(jmesh.ShardedIvfIndex, tmesh.ShardedIvfIndex, meshes, dim, ids, rows,
                     storage_dtype="float32", nlist=16, nprobe=4, initial_capacity=8192)
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=4096, device="cpu")
    flat.add_batch(ids, rows)
    queries = rows[::37][:32]
    got = t.search_batch(queries, k)
    assert_hits_match(got, j.search_batch(queries, k), F32)
    overlap = np.mean([len({x[0] for x in w} & {x[0] for x in g}) / k
                       for w, g in zip(flat.search_batch(queries, k), got)])
    assert overlap >= 0.9, overlap


def test_sharded_ivf_upsert_delete_mask(rng, meshes):
    dim = 16
    vecs = rng.standard_normal((300, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(300)]
    j, t = _ivf_pair(jmesh.ShardedIvfIndex, tmesh.ShardedIvfIndex, meshes, dim, ids, vecs,
                     storage_dtype="float32", nlist=4, nprobe=4, initial_capacity=2048)
    for idx in (j, t):
        idx.remove_batch(["d7"])
    assert t.search_batch(vecs[7:8], 1)[0][0][0] != "d7"
    assert_hits_match(t.search_batch(vecs[7:8], 4), j.search_batch(vecs[7:8], 4), F32)
    for idx in (j, t):
        idx.add_batch(["d7"], vecs[7:8])
    assert t._id_to_cell == j._id_to_cell and t._free == j._free
    assert t.search_batch(vecs[7:8], 1)[0][0][0] == "d7"
    allowed = {"d3", "d9", "d250"}
    got = t.search_batch(vecs[3:4], 3, mask=t.compile_mask(allowed))
    assert {h[0] for h in got[0]} == allowed
    assert_hits_match(got, j.search_batch(vecs[3:4], 3, mask=j.compile_mask(allowed)), F32)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_sharded_quantized_ivf_matches_flat(rng, meshes, kind):
    """Bandwidth configuration (keep_bf16): full probe and each shard's
    exact rescore return the exact index's ids, and JAX's answers."""
    jcls = jmesh.ShardedInt8IvfIndex if kind == "int8" else jmesh.ShardedInt4IvfIndex
    tcls = tmesh.ShardedInt8IvfIndex if kind == "int8" else tmesh.ShardedInt4IvfIndex
    dim, n, k = 24, 800, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    flat = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=1024, device="cpu")
    flat.add_batch(ids, vecs)
    j, t = _ivf_pair(jcls, tcls, meshes, dim, ids, vecs, storage_dtype="float32", nlist=8,
                     nprobe=8, initial_capacity=2048)
    assert len(t._overflow) == 0 and t.codes.shape[1] % 8 == 0
    assert t.codes.shape[2] == (dim if kind == "int8" else dim // 2)
    assert t.codes.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(t.codes), np.asarray(j.codes))
    queries = _queries(rng, vecs, 16)
    got = t.search_batch(queries, k)
    assert_hits_match(got, j.search_batch(queries, k), F32)
    for w, g in zip(flat.search_batch(queries, k), got):
        assert [x[0] for x in w] == [x[0] for x in g]


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_sharded_quantized_ivf_capacity_config(rng, meshes, kind):
    """keep_bf16=False: no bf16 plane, code scores, delete and mask. The
    JAX index runs its Pallas probe (interpret mode), the route whose
    cosine scores clamp at 1.0 as the port's always do (its XLA route
    leaves a code score above 1 unclamped)."""
    jcls = jmesh.ShardedInt8IvfIndex if kind == "int8" else jmesh.ShardedInt4IvfIndex
    tcls = tmesh.ShardedInt8IvfIndex if kind == "int8" else tmesh.ShardedInt4IvfIndex
    dim, n, k = 16, 600, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    j, t = _ivf_pair(jcls, tcls, meshes, dim, ids, vecs, storage_dtype="float32", nlist=4,
                     nprobe=4, initial_capacity=2048, keep_bf16=False,
                     jax_kw={"use_pallas": "force"})
    assert t.vecs is None
    got = t.search_batch(vecs[:8], 3)
    assert [row[0][0] for row in got] == [f"d{i}" for i in range(8)]
    assert_hits_match(got, j.search_batch(vecs[:8], 3), F32)
    np.testing.assert_allclose(t.get_vector("d7"), j.get_vector("d7"), rtol=0, atol=1e-6)
    for idx in (j, t):
        idx.remove_batch(["d7"])
    assert all(h[0] != "d7" for h in t.search_batch(vecs[7:8], k)[0])
    for idx in (j, t):
        idx.add_batch(["d7"], vecs[7:8])
    assert t.search_batch(vecs[7:8], 1)[0][0][0] == "d7"
    allowed = {"d1", "d5", "d9"}
    got = t.search_batch(vecs[:1], 3, mask=t.compile_mask(allowed))
    assert {h[0] for h in got[0]} == allowed
    assert_hits_match(got, j.search_batch(vecs[:1], 3, mask=j.compile_mask(allowed)), F32)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_sharded_ivf_kernel_matches_jax_pallas(rng, meshes, kind):
    """The JAX index with its Pallas probe forced (interpret mode inside
    shard_map) against the port, whose shards run their probe's plain
    version on the CPU; both configurations of the code kinds; a delete and
    a filter mask through the probe."""
    cls = {"bf16": (jmesh.ShardedIvfIndex, tmesh.ShardedIvfIndex),
           "int8": (jmesh.ShardedInt8IvfIndex, tmesh.ShardedInt8IvfIndex),
           "int4": (jmesh.ShardedInt4IvfIndex, tmesh.ShardedInt4IvfIndex)}[kind]
    dim, n, k = 16, 480, 5
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    for keep in ((True,) if kind == "bf16" else (True, False)):
        kw = {} if kind == "bf16" else {"keep_bf16": keep}
        j, t = _ivf_pair(*cls, meshes, dim, ids, vecs, storage_dtype="float32", nlist=4,
                         nprobe=4, initial_capacity=2048, use_pallas="force", **kw)
        assert j._use_pallas and t.list_cap % 8 == 0
        q = vecs[:8]
        assert_hits_match(t.search_batch(q, k), j.search_batch(q, k), F32)
        for idx in (j, t):
            idx.remove_batch(["d3"])
        assert all(h[0] != "d3" for h in t.search_batch(vecs[3:4], k)[0])
        allowed = {"d1", "d5", "d9"}
        got = t.search_batch(q[:1], 3, mask=t.compile_mask(allowed))
        assert {h[0] for h in got[0]} == allowed
        assert_hits_match(got, j.search_batch(q[:1], 3, mask=j.compile_mask(allowed)), F32)


def test_sharded_ivf_striped_placement_balances_devices(rng, meshes):
    """Rows stripe over the shards: every shard's slice of a list holds the
    same count within one, and the per-shard watermark probe stays exact."""
    dim, n = 24, 800
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    j, t = _ivf_pair(jmesh.ShardedIvfIndex, tmesh.ShardedIvfIndex, meshes, dim, ids, vecs,
                     storage_dtype="float32", nlist=8, nprobe=8, initial_capacity=2048,
                     use_pallas="force")
    s, c_local = t.n_shards, t.list_cap // t.n_shards
    per_dev = np.asarray(t.valid).reshape(t.nlist, s, c_local).sum(axis=2)
    assert (per_dev.max(axis=1) - per_dev.min(axis=1) <= 1).all()
    for sh in range(s):   # each shard's own part holds its columns
        np.testing.assert_array_equal(to_np(t.valid.part(sh)), np.asarray(j.valid)[
            :, sh * c_local:(sh + 1) * c_local])
    want = tivf.nblocks_from_counts(-(-t._next_pos // s))
    assert torch.equal(t._nblocks(), want)
    queries = _queries(rng, vecs, 8)
    assert_hits_match(t.search_batch(queries, 5), j.search_batch(queries, 5), F32)


def test_sharded_ivf_2d_replica_mesh_matches_1d(rng):
    """The raw sharded probe on a (2 x 4) mesh splits the batch over the
    replica rows: the same slots and scores as the 1-D mesh, and as JAX's."""
    from grape_vector_db_tpu.ops.kmeans import assign_clusters, kmeans

    dim, n, nlist, cap = 32, 512, 4, 256
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    cents, _ = kmeans(jnp.asarray(vecs), k=nlist, iters=4, seed=0, mode="spherical")
    assign = np.asarray(assign_clusters(jnp.asarray(vecs), cents, mode="spherical"))
    iv = np.zeros((nlist, cap, dim), np.float32)
    inr = np.zeros((nlist, cap), np.float32)
    ival = np.zeros((nlist, cap), bool)
    nxt = np.zeros(nlist, np.int64)
    for i, a in enumerate(assign):
        p_ = int(nxt[a])
        nxt[a] += 1
        iv[a, p_] = vecs[i]
        inr[a, p_] = np.linalg.norm(vecs[i])
        ival[a, p_] = True
    q = rng.standard_normal((8, dim)).astype(np.float32)
    jv, js = jmesh.sharded_ivf_topk(
        jnp.asarray(q), cents, jnp.asarray(iv), jnp.asarray(inr), jnp.asarray(ival), k=5,
        nprobe=4, metric="cosine", mesh=jax_make_mesh(n_shards=4))
    tc = torch.from_numpy(np.array(cents))
    args = (torch.from_numpy(iv), torch.from_numpy(inr), torch.from_numpy(ival))
    recip = tivf.make_recip(args[1], args[2])
    v1, s1 = tmesh.sharded_ivf_topk(torch.from_numpy(q), tc, *args, k=5, nprobe=4,
                                    metric="cosine",
                                    mesh=tmesh.make_mesh(n_shards=4, devices=[CPU]),
                                    recip=recip)
    v2, s2 = tmesh.sharded_ivf_topk(torch.from_numpy(q), tc, *args, k=5, nprobe=4,
                                    metric="cosine",
                                    mesh=tmesh.make_mesh_2d(2, n_shards=4, devices=[CPU]),
                                    recip=recip, replica_axis="replica")
    assert torch.equal(s1, s2) and torch.equal(v1, v2)
    assert_topk_match(v1, s1, jv, js, F32)


# -- the flat path's kernels on every shard ----------------------------------------------


@pytest.mark.parametrize("k", [10, 3])
def test_local_topk_takes_the_segment_kernels_above_the_threshold(rng, monkeypatch, k):
    """A shard of more than ``SEGMAX_MIN_ROWS`` rows runs B1 (k >= 4) or B2
    (k <= 3), once a shard a search (the wrappers counted here as the card
    counts launches), and answers as the plain product does."""
    from grape_vector_db_tpu_torch.ops import distance as tdist

    n_shards, per_shard, d = 4, 8192, 128
    monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 4096)
    calls = {"segmax4": 0, "segmax2": 0}
    for name in calls:
        real = getattr(tseg, f"{name}_scores")

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tseg, f"{name}_scores", counted)
    x = rng.standard_normal((n_shards * per_shard, d)).astype(np.float32)
    t = tmesh.ShardedFlatIndex(d, mesh=tmesh.make_mesh(n_shards, devices=[CPU]),
                               shard_capacity=per_shard)
    ids = [f"d{i}" for i in range(len(x))]
    t.add_batch(ids, x)
    single = FlatDeviceIndex(d, initial_capacity=len(x), device="cpu")
    single.add_batch(ids, x)
    qs = rng.standard_normal((8, d)).astype(np.float32)
    got = t.search_batch(qs, k)
    assert calls == {"segmax4": n_shards * (k >= 4), "segmax2": n_shards * (k < 4)}
    monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 1 << 30)
    assert_hits_match(got, single.search_batch(qs, k), 1e-4)


# -- the reference's faults, not copied -------------------------------------------


def _numpy_masked_top(vecs, alive, q, k):
    """f32 cosine oracle over the allowed rows: [(row, score)] best first."""
    qn = q / np.linalg.norm(q)
    s = vecs @ qn / np.linalg.norm(vecs, axis=1)
    s = np.where(alive, s, -np.inf)
    top = np.argsort(-s)[:k]
    return [(int(i), float(s[i])) for i in top]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compact_tier_drops_cells_deleted_after_the_mask(rng, meshes, kind):
    """Reference fault 1 (``mesh.py:1247-1273``): its sharded compact tier
    builds the allowed cells from the mask alone, so a mask compiled before
    a delete scores the deleted rows and k comes back short. The port ANDs
    validity in: k full, nothing deleted, exact against a numpy oracle."""
    cls = tmesh.ShardedIvfIndex if kind == "bf16" else tmesh.ShardedInt8IvfIndex
    dim, n, k = 16, 400, 8
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    t = cls(dim, mesh=meshes[1], storage_dtype="float32", nlist=4, nprobe=1,
            initial_capacity=2048)
    t.add_batch(ids, vecs)
    allowed = {f"d{i}" for i in range(0, n, 3)}
    mask = t.compile_mask(allowed)
    q = vecs[3]
    first = t.search_batch(q[None], k, mask=mask, exhaustive=True)[0]
    doomed = [h[0] for h in first[:4]]
    t.remove_batch(doomed)
    got = t.search_batch(q[None], k, mask=mask, exhaustive=True)[0]   # the stale mask
    alive = np.array([f"d{i}" in allowed and f"d{i}" not in doomed for i in range(n)])
    want = _numpy_masked_top(vecs, alive, q, k)
    assert len(got) == k and not {h[0] for h in got} & set(doomed)
    assert_hits_match([[(h[0], h[1]) for h in got]], [[(f"d{i}", s) for i, s in want]], 3e-3)


def test_compact_cache_is_keyed_by_the_cells_bytes(rng, meshes):
    """Reference fault 2 (``index/ivf.py:547``): a compact cache keyed by
    ``hash(cells.tobytes())`` would serve another filter's rows on a
    collision. The port's sharded tier keys its cache by the cells' bytes
    and the write epoch: a repeated filter reuses the gathered rows, another
    filter of the same size gathers anew and answers for itself."""
    dim, n = 16, 400
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    t = tmesh.ShardedIvfIndex(dim, mesh=meshes[1], storage_dtype="float32", nlist=4,
                              nprobe=1, initial_capacity=2048)
    t.add_batch([f"d{i}" for i in range(n)], vecs)
    evens = t.compile_mask({f"d{i}" for i in range(0, n, 2)})
    odds = t.compile_mask({f"d{i}" for i in range(1, n, 2)})
    a = t.search_batch(vecs[:2], 5, mask=evens, exhaustive=True)
    key, gathered = t._compact_cache
    m = np.asarray(evens[0]) & np.asarray(t.valid)
    m3 = m.reshape(t.nlist, t.n_shards, -1)
    assert key[2] == tuple(np.flatnonzero(m3[:, s, :].reshape(-1)).tobytes()
                           for s in range(t.n_shards))
    assert t.search_batch(vecs[:2], 5, mask=evens, exhaustive=True) == a
    assert t._compact_cache[1] is gathered
    b = t.search_batch(vecs[:2], 5, mask=odds, exhaustive=True)
    assert t._compact_cache[1] is not gathered
    assert all(int(h[0][1:]) % 2 == 1 for row in b for h in row)
    assert all(int(h[0][1:]) % 2 == 0 for row in a for h in row)


def test_streaming_tier_clamps_cosine_for_every_format(meshes):
    """Reference fault 3 (``mesh.py:931``): its sharded streaming tier clamps
    cosine scores at 1.0 for bf16 rows only, so a row whose int8 codes
    overshoot its norm scores above 1 there. The port clamps every format,
    as both single-device tiers do: its scores are the numpy oracle's code
    scores, clamped."""
    dim, n = 16, 64
    x = np.zeros((n, dim), np.float32)
    x[:, 0] = 1.0
    x[:, 1] = np.linspace(0.095, 0.105, n)    # int8 rounding lifts these dots past 1
    ids = [f"d{i}" for i in range(n)]
    q = x[32:33]
    kw = dict(storage_dtype="float32", nlist=1, nprobe=1, initial_capacity=512,
              keep_bf16=False)
    j = jmesh.ShardedInt8IvfIndex(dim, mesh=meshes[0], **kw)
    t = tmesh.ShardedInt8IvfIndex(dim, mesh=meshes[1], **kw)
    scores = {}
    for name, idx in (("jax", j), ("port", t)):
        idx.add_batch(ids, x)
        idx.compact_max_bytes = 0                      # the streaming tier
        hits = idx.search_batch(q, 10, mask=idx.compile_mask(set(ids)), exhaustive=True)
        scores[name] = [h[1] for h in hits[0]]
    qb = torch.from_numpy(q / np.linalg.norm(q)).to(torch.bfloat16).float().numpy()
    oracle = (qb @ np.asarray(t.codes)[0].astype(np.float32).T)[0] * np.asarray(t.factor)[0]
    assert oracle.max() > 1.0 + 1e-5 and max(scores["jax"]) > 1.0 + 1e-5
    want = np.sort(np.minimum(oracle, 1.0))[::-1][:10]
    np.testing.assert_allclose(scores["port"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_load_state_takes_a_jax_sharded_index(rng, meshes, kind):
    """A JAX sharded IVF index's whole state, read back with ``np.asarray``
    (its kernel off, so it keeps no weight plane: the port makes one), split
    over the port's mesh by ``load_state``: the same planes shard by shard
    and the same answers, through a delete and a mask."""
    jcls, tcls = ((jmesh.ShardedIvfIndex, tmesh.ShardedIvfIndex) if kind == "bf16"
                  else (jmesh.ShardedInt8IvfIndex, tmesh.ShardedInt8IvfIndex))
    dim, n = 16, 600
    x = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    kw = dict(storage_dtype="float32", nlist=4, nprobe=2, initial_capacity=512)
    j = jcls(dim, mesh=meshes[0], **kw)
    j.add_batch(ids, x)
    assert len(j._overflow) > 0
    o = j._overflow
    state = dict(centroids=np.asarray(j.centroids), norms=np.asarray(j.norms),
                 valid=np.asarray(j.valid), list_cap=j.list_cap, next_pos=j._next_pos,
                 free=j._free, id_to_cell=j._id_to_cell, vecs=np.asarray(j.vecs), recip=None,
                 overflow=dict(vectors=np.asarray(o.vectors), norms=np.asarray(o.norms),
                               valid=np.asarray(o.valid), slot_to_id=o._slot_to_id,
                               free=o._free, high_water=o._high_water))
    if kind == "int8":
        assert j.factor is None
        state.update(codes=np.asarray(j.codes), scales=np.asarray(j.scales), factor=None)
    t = tcls(dim, mesh=meshes[1], **kw)
    t.load_state(**state)
    c_local = t.list_cap // 8
    for s in range(8):
        np.testing.assert_array_equal(to_np(t.vecs.part(s)),
                                      state["vecs"][:, s * c_local:(s + 1) * c_local])
    q = _queries(rng, x, 8)
    assert_hits_match(t.search_batch(q, 5), j.search_batch(q, 5), F32)
    for idx in (j, t):
        idx.remove_batch(["d1", "d2"])
    allowed = {f"d{i}" for i in range(0, n, 7)}
    assert_hits_match(t.search_batch(q, 5, mask=t.compile_mask(allowed)),
                      j.search_batch(q, 5, mask=j.compile_mask(allowed)), F32)

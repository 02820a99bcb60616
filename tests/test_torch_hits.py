"""The port's bulk hit builder (``index.hits.hits_from_arrays``) and overflow
merge (``index.hits.merge_hits``) against the per-hit loop they replaced,
kept as their plain version in tests/torch_parity.py, on the CPU (the card's
cases are in tests/test_torch_cuda.py).

Every case asks for exact equality, order included: the same ids, the same
Python floats. The array cases build the read-back arrays by hand (single
hits, 100 hits, the 1,000 x 10 batch, f64 scores, ``-inf`` entries, freed
slots, empty rows, ties at the cosine clamp of 1.0); the index cases record
the arrays a real search read back, in every kind that builds hits, and hold
its answer to the loop over them. IVF's id table by cell is checked against
the bookkeeping it mirrors (``_id_to_cell``) through adds, removes,
``optimize()`` and ``clear()``, in every IVF layout.
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu_torch.index import (BinaryDeviceIndex, FlatDeviceIndex,
                                             Int8IvfDeviceIndex, IvfDeviceIndex,
                                             IvfPqDeviceIndex, ProjectedInt8IvfIndex)
from grape_vector_db_tpu_torch.index.hits import hits_from_arrays, merge_hits
from grape_vector_db_tpu_torch.parallel import mesh as tmesh
from torch_parity import cell_map, per_hit, per_row_merge

torch.set_num_threads(2)

D = 32
CPU = torch.device("cpu")


def _assert_same(got, want):
    assert got == want
    assert all(type(i) is str and type(s) is float for row in got for i, s in row)


def _clustered(rng, n, d=D, k=6, spread=0.3):
    centers = rng.standard_normal((k, d)).astype(np.float32)
    return (centers[rng.integers(0, k, n)]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _sorted_scores(rng, b, k, dtype=np.float32):
    return -np.sort(-rng.random((b, k)).astype(dtype), axis=1)


def _record(monkeypatch, owner, name):
    """Wrap ``owner.name`` to keep each call's arguments and result."""
    calls = []
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(owner, name, wrapped)
    return calls


def _old_cell_dict(t):
    """The dict by cell the IVF loop read, made from ``_id_to_cell``."""
    return {lst * t.list_cap + pos: i for i, (lst, pos) in t._id_to_cell.items()}


# -- array cases --------------------------------------------------------------


def _arrays(rng, b, k, n=4096, dtype=np.float32):
    """Scores sorted as a top-k returns them, and distinct slots a row (a
    top-k never names a slot twice)."""
    ids = [f"doc-{i}" for i in range(n)]
    slots = np.stack([rng.choice(n, k, replace=False) for _ in range(b)])
    return _sorted_scores(rng, b, k, dtype), slots, ids


def case_b1_k1(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 1, 1)
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_b1_k100(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 1, 100)
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_b1000_k10(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 1000, 10, n=1 << 20)
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_f64_scores(rng, monkeypatch):
    # as hamming_only_topk hands them over: 1 - d / dim in f64
    vals, slots, ids = _arrays(rng, 8, 10, dtype=np.float64)
    vals[3, 6:] = -np.inf
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_neg_inf_entries(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 16, 10)
    vals[2, 7:] = -np.inf
    vals[5, 1:] = -np.inf
    vals[9, 9] = -np.inf
    slots[2, 7:] = 0
    slots[5, 1:] = 1 << 40          # a padded entry's slot need name no id
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_freed_slots(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 16, 10, n=64)
    for s in (3, 17, 40, 41):
        ids[s] = None
    vals[4, 8:] = -np.inf
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_empty_rows(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 6, 10)
    vals[0] = vals[4] = -np.inf
    none = np.full((2, 5), -np.inf, dtype=np.float32)
    zero = np.zeros((3, 0), dtype=np.float32)
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__)),
            (hits_from_arrays(none, np.zeros((2, 5), np.int64), ids), [[], []]),
            (hits_from_arrays(zero, zero.astype(np.int64), ids), [[], [], []]),
            (hits_from_arrays(zero[:0], zero[:0].astype(np.int64), ids), [])]


def case_ties_at_one(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 8, 10)
    vals[:, :4] = 1.0
    vals[2, :] = 1.0
    return [(hits_from_arrays(vals, slots, ids), per_hit(vals, slots, ids.__getitem__))]


def case_cell_table(rng, monkeypatch):
    # IVF's table: ids by cell, None where empty, mostly empty
    table = [None] * (4 * 512)
    cells = rng.choice(len(table), 900, replace=False)
    for n, c in enumerate(cells):
        table[c] = f"doc-{n}"
    vals = _sorted_scores(rng, 32, 10)
    slots = rng.choice(cells, (32, 10))
    slots[7, 3] = np.setdiff1d(np.arange(len(table)), cells)[0]   # an empty cell
    vals[11, 5:] = -np.inf
    lookup = {int(c): table[c] for c in cells}.get
    one_v, one_s = vals[:1, :1], slots[:1, :1]
    return [(hits_from_arrays(vals, slots, table), per_hit(vals, slots, lookup)),
            (hits_from_arrays(one_v, one_s, table), per_hit(one_v, one_s, lookup))]


def case_merge(rng, monkeypatch):
    vals, slots, ids = _arrays(rng, 12, 10, n=256)
    vals[:, :2] = 1.0
    rows = hits_from_arrays(vals, slots, ids)
    extra = [[] for _ in range(12)]
    extra[1] = [("over-a", 1.0), ("over-b", 0.5)]             # ties with the main row's 1.0
    extra[4] = [(rows[4][3][0], rows[4][3][1]), ("over-c", 0.99)]   # an id in both
    extra[7] = [(f"over-{j}", 2.0 - j / 10) for j in range(12)]      # more than k
    want = per_row_merge(per_hit(vals, slots, ids.__getitem__), extra, 10)
    assert merge_hits(rows, extra, 10) == 3
    return [(rows, want)]


# -- index cases: the arrays a real search read back ----------------------------


def _flat_kind(rng, monkeypatch, cls, **kw):
    x = _clustered(rng, 300)
    ids = [f"d{i}" for i in range(300)]
    idx = cls(D, initial_capacity=256, device="cpu", **kw)
    idx.add_batch(ids, x)
    idx.remove_batch(ids[10:40])                     # freed slots
    calls = _record(monkeypatch, idx, "hits_from_slots")
    q = np.concatenate([x[:3], x[::37] + 0.05])      # x[:3]: ties at the clamp of 1.0
    got = [idx.search_batch(q, 10), idx.search_batch(q[:1], 100),
           idx.search_batch(q[:2], 512)]             # k past the live rows: -inf entries
    assert len(calls) == 3 and any(not np.isfinite(a[0]).all() for a, _ in calls)
    pairs = [(g, per_hit(*a, idx._slot_to_id.__getitem__)) for g, (a, _) in zip(got, calls)]
    return pairs, idx, q, calls


def case_flat(rng, monkeypatch):
    return _flat_kind(rng, monkeypatch, FlatDeviceIndex)[0]


def case_binary(rng, monkeypatch):
    pairs, idx, q, calls = _flat_kind(rng, monkeypatch, BinaryDeviceIndex)
    got = idx.hamming_only_topk(q, 20)
    (vals, slots), _ = calls[-1]
    assert vals.dtype == np.float64
    return pairs + [(got, per_hit(vals, slots, idx._slot_to_id.__getitem__))]


def _ivf_pairs(idx, calls, got):
    pairs = []
    for g, ((vals, slots, cell_ids, o_hits, k), _) in zip(got, calls):
        assert cell_ids is idx._cell_ids
        extra = o_hits or [[] for _ in range(len(vals))]
        want = per_row_merge(per_hit(vals, slots, _old_cell_dict(idx).get), extra, k)
        pairs.append((g, want))
    return pairs


def _ivf_kind(rng, monkeypatch, cls, n=1000, **kw):
    x = _clustered(rng, n)
    # copies of the first rows at the end: they spill to the overflow, where
    # they tie with their originals in the lists
    x = np.concatenate([x, x[:4]])
    ids = [f"d{i}" for i in range(len(x))]
    idx = cls(D, nlist=4, nprobe=4, initial_capacity=512, device="cpu", **kw)
    idx.add_batch(ids, x)
    idx.remove_batch(ids[50:60])
    calls = _record(monkeypatch, idx, "_hits")
    q = np.concatenate([x[:4], x[::53] + 0.05])
    return idx, calls, q


def case_ivf_overflow(rng, monkeypatch):
    idx, calls, q = _ivf_kind(rng, monkeypatch, IvfDeviceIndex)
    assert len(idx._overflow) > 0
    got = [idx.search_batch(q, 10), idx.search_batch(q[:1], 100)]
    assert idx.counters()["ivf_overflow_merge_rows_total"] == len(q) + 1
    return _ivf_pairs(idx, calls, got)


def case_ivf(rng, monkeypatch):
    idx, calls, q = _ivf_kind(rng, monkeypatch, IvfDeviceIndex)
    idx.optimize()
    assert len(idx._overflow) == 0
    idx.remove_batch(["d3", "d70"])
    got = [idx.search_batch(q, 10), idx.search_batch(q[:2], 100),
           idx.search_batch(q[:1], 1024, exhaustive=True,
                            mask=idx.compile_mask({f"d{i}" for i in range(0, 900, 7)}))]
    assert idx.counters()["ivf_overflow_merge_rows_total"] == 0
    return _ivf_pairs(idx, calls, got)


def case_ivf_pq(rng, monkeypatch):
    idx, calls, q = _ivf_kind(rng, monkeypatch, IvfPqDeviceIndex, n_sub=8)
    assert idx.codebooks is not None and len(idx._overflow) > 0
    got = [idx.search_batch(q, 10), idx.search_batch(q[:1], 100)]
    return _ivf_pairs(idx, calls, got)


def case_mesh(rng, monkeypatch):
    x = _clustered(rng, 400)
    ids = [f"d{i}" for i in range(400)]
    t = tmesh.ShardedFlatIndex(D, mesh=tmesh.make_mesh(n_shards=4, devices=[CPU]),
                               storage_dtype="float32", shard_capacity=128)
    t.add_batch(ids, x)
    t.remove_batch(ids[::9])
    calls = _record(monkeypatch, tmesh, "hits_from_arrays")
    q = np.concatenate([x[:3], x[1::41] + 0.05])
    got = [t.search_batch(q, 10), t.search_batch(q[:1], 100)]
    return [(g, per_hit(a[0], a[1], t._slot_to_id.__getitem__)) for g, (a, _) in zip(got, calls)]


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_bulk_hits_equal_the_per_hit_loop(rng, monkeypatch, case):
    pairs = CASES[case](rng, monkeypatch)
    assert pairs
    for got, want in pairs:
        _assert_same(got, want)


# -- IVF's id table by cell -----------------------------------------------------


def _sharded_ivf(**kw):
    return tmesh.ShardedIvfIndex(D, mesh=tmesh.make_mesh(n_shards=4, devices=[CPU]), **kw)


IVF_LAYOUTS = {
    "ivf": (D, lambda **kw: IvfDeviceIndex(D, device="cpu", **kw)),
    "ivf_int8_codes": (D, lambda **kw: Int8IvfDeviceIndex(D, keep_bf16=False, device="cpu",
                                                          **kw)),
    "ivf_pq": (D, lambda **kw: IvfPqDeviceIndex(D, n_sub=8, device="cpu", **kw)),
    "ivf_int8_proj": (256, lambda **kw: ProjectedInt8IvfIndex(256, proj_dim=128,
                                                             device="cpu", **kw)),
    "sharded_ivf": (D, _sharded_ivf),
}


def _assert_table(t):
    assert len(t._cell_ids) == t.nlist * t.list_cap
    assert cell_map(t) == _old_cell_dict(t)


@pytest.mark.parametrize("layout", list(IVF_LAYOUTS))
def test_ivf_id_table_follows_every_write(rng, layout):
    d, make = IVF_LAYOUTS[layout]
    x = _clustered(rng, 900, d=d)
    ids = [f"d{i}" for i in range(900)]
    t = make(nlist=4, nprobe=4, initial_capacity=512)
    t.add_batch(ids[:700], x[:700])
    cap = t.list_cap
    assert len(t._overflow) > 0 and len(t._id_to_cell) > 0
    _assert_table(t)
    gone = [i for i in ids[:700:5] if i in t._id_to_cell]
    cells = [t._id_to_cell[i] for i in gone]
    assert t.remove_batch(ids[:700:5]) == 140
    _assert_table(t)
    assert all(t._cell_ids[lst * t.list_cap + pos] is None for lst, pos in cells)
    t.add_batch(ids[700:], x[700:])                  # fills the freed cells first
    _assert_table(t)
    t.optimize()                                     # retrain, grow list_cap, repack
    assert t.list_cap > cap and len(t._overflow) == 0 and len(t._id_to_cell) == 760
    _assert_table(t)
    got = t.search_batch(x[1:2], 1)[0]
    assert got and got[0][0] == "d1"
    t.clear()
    assert len(t._cell_ids) == t.nlist * t.list_cap and not cell_map(t)
    t.add_batch(ids[:300], x[:300])
    _assert_table(t)


def test_overflow_merge_counter_reads_rows_merged(rng):
    x = _clustered(rng, 1000)
    ids = [f"d{i}" for i in range(1000)]
    t = IvfDeviceIndex(D, nlist=4, nprobe=4, initial_capacity=512, device="cpu")
    t.add_batch(ids, x)
    assert len(t._overflow) > 0
    assert t.counters()["ivf_overflow_merge_rows_total"] == 0
    t.search_batch(x[:5], 10)
    assert t.counters()["ivf_overflow_merge_rows_total"] == 5
    t.optimize()                                     # absorbs the spill
    assert len(t._overflow) == 0
    t.search_batch(x[:7], 10)
    assert t.counters()["ivf_overflow_merge_rows_total"] == 5

    fresh = IvfDeviceIndex(D, nlist=4, nprobe=4, initial_capacity=512, device="cpu")
    fresh.add_batch(ids, x)
    fresh.optimize()                                 # as the benchmark's load ends
    fresh.search_batch(x[:8], 10)
    assert fresh.counters()["ivf_overflow_merge_rows_total"] == 0

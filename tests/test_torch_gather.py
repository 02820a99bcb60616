"""CPU tests of B11's grouping step and routing rule in the PyTorch port.

The grouped route's kernels run only on a card (tests/test_torch_cuda.py);
here the plain form of its grouping step is held against numpy, and the rule
that picks a route against the shapes of the graph path.
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu_torch.ops import gather as tgat


def _numpy_grouping(ids: np.ndarray, n: int, group_queries: int):
    """(order, rep, totals) by the grouping step's definition: rep[b, c] is
    the first column of row b naming the same clamped row; the first copies,
    stably sorted by (query group, clamped row), then -1; the first copies of
    each query group."""
    b, c = ids.shape
    rows = np.clip(ids, 0, n - 1)
    rep = np.empty((b, c), np.int32)
    for i in range(b):
        first = {}
        for j in range(c):
            rep[i, j] = first.setdefault(int(rows[i, j]), j)
    flat = np.flatnonzero(rep.reshape(-1) == np.tile(np.arange(c), b))
    key = (flat // max(c, 1) // group_queries) * n + rows.reshape(-1)[flat]
    order = np.full(b * c, -1, np.int32)
    order[:flat.size] = flat[np.argsort(key, kind="stable")]
    totals = np.bincount(flat // max(c, 1) // group_queries,
                         minlength=-(-b // group_queries)).astype(np.int32)
    return order, rep, totals


def _ids(kind: str, b: int, c: int, n: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    if kind == "hot":
        return np.full((b, c), 3, np.int32)
    if kind == "repeats":
        return (g.integers(0, 6, (b, c)) * 7 % n).astype(np.int32)
    ids = g.integers(-2 * n, 3 * n, (b, c)).astype(np.int32)   # clamped ids
    if ids.size:
        ids.reshape(-1)[:2] = [-(1 << 31), (1 << 31) - 1]
    return ids


@pytest.mark.parametrize("kind,b,c,n,group_queries", [
    ("clamped", 12, 40, 30, 512), ("hot", 9, 25, 50, 512), ("repeats", 16, 64, 100, 512),
    ("clamped", 0, 7, 30, 512), ("clamped", 6, 0, 30, 512), ("clamped", 11, 17, 40, 4),
    ("repeats", 10, 33, 500, 3)])
def test_group_pairs_plain_matches_numpy(monkeypatch, kind, b, c, n, group_queries):
    """The plain grouping step against numpy's stable sort by clamped row,
    with each list's repeats folded onto their first copy, across query
    groups (a small GROUP_QUERIES stands in for B > 512) and on empty
    inputs; on a CPU tensor group_pairs is the plain form."""
    monkeypatch.setattr(tgat, "GROUP_QUERIES", group_queries)
    ids = _ids(kind, b, c, n, seed=b * 31 + c)
    want = _numpy_grouping(ids, n, group_queries)
    for fn in (tgat.group_pairs_ref, tgat.group_pairs):
        got = fn(torch.from_numpy(ids), n)
        for name, x, y in zip(("order", "rep", "totals"), got, want):
            assert x.dtype == torch.int32, name
            np.testing.assert_array_equal(x.numpy(), y, err_msg=name)


def test_group_pairs_folds_a_hot_row_to_one_pair_a_query():
    order, rep, totals = tgat.group_pairs_ref(torch.full((4, 9), 5, dtype=torch.int32), 8)
    assert torch.equal(rep, torch.zeros((4, 9), dtype=torch.int32))
    assert torch.equal(order[:4], torch.tensor([0, 9, 18, 27], dtype=torch.int32))
    assert bool((order[4:] == -1).all()) and totals.tolist() == [4]


@pytest.mark.parametrize("b,c,dtype,route", [
    (128, 256, torch.bfloat16, "pairs"),      # a beam iteration: expand 8 x degree 32
    (128, 64, torch.bfloat16, "pairs"),       # the beam's entry step: 64 entries
    (2048, 576, torch.bfloat16, "grouped"),   # an NN-descent build chunk
    (2048, 576, torch.float32, "pairs"),      # f32 storage: the pairs route only
    (1024, 512, torch.bfloat16, "grouped"),   # 2^19 pairs: the crossover
    (1023, 512, torch.bfloat16, "pairs"),
    (5000, 64, torch.bfloat16, "pairs")])
def test_gather_route_rule(b, c, dtype, route):
    assert tgat.gather_route(b, c, 768, dtype) == route


@pytest.mark.parametrize("route", [None, "pairs", "grouped"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_dots_on_cpu_is_the_plain_version(route, dtype):
    """On CPU tensors every route runs the plain version and launches
    nothing; an unknown route raises."""
    g = np.random.default_rng(3)
    q = torch.from_numpy(g.standard_normal((6, 40)).astype(np.float32))
    v = torch.from_numpy(g.standard_normal((30, 40)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(g.integers(-5, 35, (6, 11)).astype(np.int32))
    before = dict(tgat.LAUNCHES)
    got = tgat.gather_dots(q, v, ids, route=route)
    assert torch.equal(got, tgat.gather_dots_ref(q, v, ids))
    assert tgat.LAUNCHES == before
    with pytest.raises(ValueError, match="route"):
        tgat.gather_dots(q, v, ids, route="sorted")

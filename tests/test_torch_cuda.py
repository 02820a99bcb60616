"""Tests of the port that need a CUDA card; each skips without one.

This file imports no JAX (the machine with the card has none), so it runs
there on its own, without the JAX test harness in tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

With integer-valued inputs every sum is exact in f32, so there the CUDA
kernels and their plain versions must agree bit for bit, ties included.
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu_torch.index.flat import FlatIndex
from grape_vector_db_tpu_torch.ops import distance as tdist
from grape_vector_db_tpu_torch.ops import segmax as tseg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _integer_case(n=8192, d=128, b=40, seed=0):
    g = np.random.default_rng(seed)
    v = g.integers(-2, 3, (n, d)).astype(np.float32)
    for m in (3, 7, 20):                      # duplicates inside one segment
        v[4096 + 5 + 128 * m] = v[77]
    q = g.integers(-2, 3, (b, d)).astype(np.float32)
    w = (g.random(n) > 0.05).astype(np.float32)
    w[[9 + 128 * m for m in range(32)]] = 0.0  # one all-invalid segment
    return torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(w)


@pytest.mark.cuda
@pytest.mark.parametrize("topj", [4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmax_kernel_matches_plain(cuda, topj, dtype):
    v, q, w = _integer_case()
    v, q, w = v.to(cuda).to(getattr(torch, dtype)), q.to(cuda), w.to(cuda)
    kern = tseg.segmax4_scores if topj == 4 else tseg.segmax2_scores
    plain = tseg.segmax4_scores_ref if topj == 4 else tseg.segmax2_scores_ref
    before = tseg.LAUNCHES[f"segmax{topj}"]
    got = kern(q, v, w)
    torch.cuda.synchronize()
    assert tseg.LAUNCHES[f"segmax{topj}"] == before + 1
    for a, b in zip(got, plain(q, v, w)):
        assert torch.equal(a.float(), b.float())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 10])
def test_flat_index_on_cuda_matches_cpu(cuda, monkeypatch, k):
    """The same bf16 index on the card (kernel route, thresholds lowered)
    and on the CPU (plain versions) returns the same hits; scores within
    1e-4 (f32 sums in different orders)."""
    monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 4096)
    g = np.random.default_rng(1)
    v = g.standard_normal((6000, 128)).astype(np.float32)
    q = g.standard_normal((16, 128)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(v))]
    tseg.reset_launch_counts()
    hits = []
    for dev in (cuda, "cpu"):
        idx = FlatIndex(128, device=dev)
        idx.add_batch(ids, v)
        idx.remove_batch(ids[:50])
        hits.append(idx.search_batch(q, k))
    assert tseg.LAUNCHES["segmax4" if k >= 4 else "segmax2"] == 1
    for got, want in zip(*hits):
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=0, atol=1e-4)

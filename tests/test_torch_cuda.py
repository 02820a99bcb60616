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

from grape_vector_db_tpu_torch.index import (FlatIndex, Int4IvfDeviceIndex, Int8IvfDeviceIndex,
                                             IvfDeviceIndex)
from grape_vector_db_tpu_torch.ops import distance as tdist
from grape_vector_db_tpu_torch.ops import ivf as tivf
from grape_vector_db_tpu_torch.ops import segmax as tseg
from grape_vector_db_tpu_torch.ops.int4 import quantize_int4


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


def _probe_case(fmt, n_lists=8, cap=128, d=128, b=24, p=6, seed=0):
    """Small-integer lists, weights of 0.5, 1 and 2 (zeroed inside two
    lists), ragged nblocks (0, odd, past the capacity), duplicate probes."""
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.integers(-3, 4, (n_lists, cap, d)).astype(np.float32))
    q = torch.from_numpy(g.integers(-3, 4, (b, d)).astype(np.float32))
    w = g.choice([0.5, 1.0, 2.0], (n_lists, cap)).astype(np.float32)
    w[0, 10:30] = 0.0
    w[3, 64:70] = 0.0
    nb = torch.tensor([2, 1, 0, 2, 1, 3, 2, 1], dtype=torch.int32)
    probe = torch.from_numpy(g.integers(0, n_lists, (b, p)).astype(np.int32))
    probe[:, 1] = probe[:, 0]
    if fmt == "bf16":
        data = x.to(torch.bfloat16)
    elif fmt == "int8":
        data = x.to(torch.int8)
    elif fmt == "int4":
        data = quantize_int4(x.reshape(-1, d))[0].reshape(n_lists, cap, d // 2)
    else:
        data = x
    return q, probe, data, torch.from_numpy(w), nb


_PROBES = {"bf16": ("ivf_probe", tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref),
           "f32": ("ivf_probe", tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref),
           "int8": ("ivf_probe_int8", tivf.ivf_probe_scores_int8, tivf.ivf_probe_scores_int8_ref),
           "int4": ("ivf_probe_int4", tivf.ivf_probe_scores_int4, tivf.ivf_probe_scores_int4_ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "f32", "int8", "int4"])
def test_ivf_probe_kernel_matches_plain(cuda, fmt):
    name, kern, plain = _PROBES[fmt]
    args = [t.to(cuda) for t in _probe_case(fmt)]
    before = tivf.LAUNCHES[name]
    got = kern(*args)
    torch.cuda.synchronize()
    assert tivf.LAUNCHES[name] == before + 1
    want = plain(*args)
    assert torch.equal(got, want)
    assert (got[args[1] == 2] == -1e9).all()        # list 2 has nblocks 0


@pytest.mark.cuda
def test_ivf_probe_kernel_refuses_what_it_cannot_load(cuda):
    """A CUDA tensor the kernel cannot take raises; it never falls back."""
    q, probe, data, w, nb = (t.to(cuda) for t in _probe_case("bf16", d=36))
    with pytest.raises(ValueError, match="16 bytes"):
        tivf.ivf_probe_scores(q, probe, data, w, nb)
    with pytest.raises(ValueError, match="CUDA device"):
        tivf.ivf_probe_scores(q, probe.cpu(), data, w, nb)


def _port_state(t):
    """A port IVF index's state as numpy, for load_state (bf16 as f32: the
    values are exact in bf16)."""
    def arr(x):
        return None if x is None else x.float().cpu().numpy() if x.is_floating_point() \
            else x.cpu().numpy()

    o = t._overflow
    st = dict(centroids=arr(t.centroids), norms=arr(t.norms), valid=arr(t.valid),
              list_cap=t.list_cap, next_pos=t._next_pos, free=t._free,
              id_to_cell=t._id_to_cell, vecs=arr(t.vecs), recip=arr(t.recip),
              overflow=dict(vectors=arr(o.vectors), norms=arr(o.norms), valid=arr(o.valid),
                            slot_to_id=o._slot_to_id, free=o._free, high_water=o._high_water))
    if hasattr(t, "codes"):
        st.update(codes=arr(t.codes), scales=arr(t.scales), factor=arr(t.factor))
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf", "ivf_int8", "ivf_int4"])
def test_ivf_index_on_cuda_matches_cpu(cuda, kind):
    """One IVF state on the CPU (plain versions) and on the card (kernels):
    the same hits for plain, masked and both exhaustive tiers' searches;
    scores within 1e-4 (f32 sums in different orders)."""
    cls = {"ivf": IvfDeviceIndex, "ivf_int8": Int8IvfDeviceIndex,
           "ivf_int4": Int4IvfDeviceIndex}[kind]
    g = np.random.default_rng(2)
    centres = g.standard_normal((20, 128)).astype(np.float32)
    v = (centres[g.integers(0, 20, 5000)] + 0.3 * g.standard_normal((5000, 128))).astype(np.float32)
    q = v[:12] + 0.05 * g.standard_normal((12, 128)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(v))]
    cpu = cls(128, nlist=16, nprobe=4, initial_capacity=2048, device="cpu")
    cpu.add_batch(ids, v)
    cpu.remove_batch(ids[:40])
    card = cls(128, nlist=16, nprobe=4, initial_capacity=2048, device=cuda)
    card.load_state(**_port_state(cpu))
    allowed = set(ids[::7])
    tivf.reset_launch_counts()
    for kw in ({}, {"mask": "in-probe"}, {"mask": "compact"}, {"mask": "streaming"}):
        got = []
        for idx in (card, cpu):
            idx.compact_max_bytes = 0 if kw.get("mask") == "streaming" else 1 << 30
            mask = None if not kw else idx.compile_mask(allowed)
            got.append(idx.search_batch(q, 10, mask=mask,
                                        exhaustive=kw.get("mask") in ("compact", "streaming")))
        for a, b in zip(*got):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-4)
    name = {"ivf": "ivf_probe", "ivf_int8": "ivf_probe_int8", "ivf_int4": "ivf_probe_int4"}[kind]
    assert tivf.LAUNCHES[name] == 3       # plain, in-probe mask, streaming phase 2


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

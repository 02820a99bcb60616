"""Parity of the PyTorch port's FlatDeviceIndex with the JAX one, on the CPU.

The same ids and numpy vectors (made from a seed) go through both indexes;
slot bookkeeping must be identical and the stored planes equal. Search
tolerances: f32 storage 1e-5, bf16 storage 1e-4 (tests/torch_parity.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from grape_vector_db_tpu.index.flat import FlatDeviceIndex as JaxFlat
from grape_vector_db_tpu_torch.index.flat import FlatIndex
from torch_parity import assert_hits_match, to_np

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _both(dim=32, cap=8, dtype="bfloat16", metric="cosine"):
    return (JaxFlat(dim, metric=metric, storage_dtype=dtype, initial_capacity=cap),
            FlatIndex(dim, metric=metric, storage_dtype=dtype, initial_capacity=cap,
                      device="cpu"))


def _assert_same_state(j, t):
    assert t.capacity == j.capacity
    assert t._slot_to_id == j._slot_to_id
    assert t._id_to_slot == j._id_to_slot
    assert t._free == j._free and t._high_water == j._high_water
    np.testing.assert_array_equal(to_np(t.vectors), np.asarray(j.vectors, np.float32))
    np.testing.assert_array_equal(to_np(t.valid), np.asarray(j.valid))
    np.testing.assert_allclose(to_np(t.norms), np.asarray(j.norms), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_overwrite_delete_reuse_and_growth(rng, dtype):
    j, t = _both(dtype=dtype)
    x = rng.standard_normal((20, 32)).astype(np.float32)
    ids = [f"d{i}" for i in range(20)]
    for idx in (j, t):
        idx.add_batch(ids[:6], x[:6])
        # overwrite + duplicate ids inside one batch (last write wins)
        idx.add_batch(["d1", "d2", "d1"], x[[10, 11, 12]])
        assert idx.remove_batch(["d0", "d4", "nope"]) == 2
        # freed slots are reused, then capacity doubles twice (8 -> 32)
        idx.add_batch(ids[6:20], x[6:20])
    _assert_same_state(j, t)
    assert t.capacity == 32 and len(t) == 18
    np.testing.assert_array_equal(t.get_vector("d1"), np.asarray(j.get_vector("d1")))
    assert t.get_vector("d0") is None
    tid, tv = t.get_all()
    jid, jv = j.get_all()
    assert tid == jid
    np.testing.assert_array_equal(tv, np.asarray(jv))
    assert dataclasses.asdict(t.get_stats()) == dataclasses.asdict(j.get_stats())
    q = rng.standard_normal((3, 32)).astype(np.float32)
    assert_hits_match(t.search_batch(q, 5), j.search_batch(q, 5), TOL[dtype])
    t.clear()
    j.clear()
    _assert_same_state(j, t)
    assert t.search_batch(q, 5) == [[], [], []]


def test_compile_mask_and_masked_search(rng):
    j, t = _both(dim=16, cap=64)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    ids = [f"d{i}" for i in range(50)]
    for idx in (j, t):
        idx.add_batch(ids, x)
        idx.remove_batch(ids[:5])
    allowed = {f"d{i}" for i in range(0, 50, 3)} | {"missing"}
    mt, mj = t.compile_mask(allowed), j.compile_mask(allowed)
    np.testing.assert_array_equal(mt, mj)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    got = t.search_batch(q, 6, mask=mt)
    assert_hits_match(got, j.search_batch(q, 6, mask=mj), 1e-4)
    assert all(i in allowed and i not in ids[:5] for row in got for i, _ in row)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_state_from_jax_index(rng, dtype):
    """A JAX index's arrays, read back with np.asarray (bf16 comes back as an
    ml_dtypes array), load into the port and search the same."""
    j, _ = _both(dim=64, cap=256, dtype=dtype, metric="dot")
    x = rng.standard_normal((300, 64)).astype(np.float32)
    j.add_batch([f"d{i}" for i in range(300)], x)
    j.remove_batch(["d7", "d100"])
    t = FlatIndex(64, metric="dot", storage_dtype=dtype, device="cpu")
    t.load_state(np.asarray(j.vectors), np.asarray(j.norms), np.asarray(j.valid),
                 j._slot_to_id, j._free, j._high_water)
    _assert_same_state(j, t)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    assert_hits_match(t.search_batch(q, 10), j.search_batch(q, 10), TOL[dtype])
    # writes after the load keep the bookkeeping in step
    for idx in (j, t):
        idx.add_batch(["new", "d3"], x[:2])
    _assert_same_state(j, t)


def test_default_device_is_cuda_and_fails_without_a_card():
    """No fallback hides the device: the default is CUDA, and without a card
    the index fails where it allocates, instead of quietly using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        FlatIndex(16)

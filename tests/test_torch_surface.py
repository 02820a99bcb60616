"""The port's public surface matches the reference's, on the CPU.

- Every index class of the port takes the reference class's keywords, in the
  reference's order (a positional call binds the same parameter in both
  packages); the port may add trailing keywords. ``recall_target`` and
  ``use_pallas`` are accepted and ignored: the port's selections are exact
  and it has no Pallas.
- ``grape_vector_db_tpu_torch.ops`` exports every name of the reference's
  ``ops.__all__``, with the reference's parameters in its order.
- ``l2_normalize(..., axis=)`` and ``scored_topk(..., recall_target=)`` give
  what the calls without the keyword give.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grape_vector_db_tpu.ops as jops
import grape_vector_db_tpu_torch.ops as tops
from grape_vector_db_tpu.ops import distance as jdist
from grape_vector_db_tpu_torch.ops import distance as tdist

# (module under index/, class) present in both packages
INDEX_CLASSES = [
    ("flat", "FlatDeviceIndex"), ("binary", "BinaryDeviceIndex"),
    ("int8", "Int8DeviceIndex"), ("pq", "PqDeviceIndex"), ("ivf", "IvfDeviceIndex"),
    ("ivf_int8", "Int8IvfDeviceIndex"), ("ivf_int4", "Int4IvfDeviceIndex"),
    ("ivf_pq", "IvfPqDeviceIndex"), ("ivf_proj", "ProjectedInt8IvfIndex"),
    ("ivf_proj", "ProjectedInt4IvfIndex"), ("graph", "GraphDeviceIndex"),
]
_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _classes(module, name):
    ref = getattr(importlib.import_module(f"grape_vector_db_tpu.index.{module}"), name)
    port = getattr(importlib.import_module(f"grape_vector_db_tpu_torch.index.{module}"), name)
    return ref, port


def _params(fn):
    return [p for p in inspect.signature(fn).parameters.values() if p.name != "self"]


def _full_keywords(cls):
    """Every named constructor parameter of ``cls`` with its default, down the
    MRO through each ``**kwargs`` that forwards to the next class."""
    out = {}
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        params = _params(init)
        for p in params:
            if p.kind not in _VARIADIC and p.name not in out:
                out[p.name] = p.default
        if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
            break
    return out


@pytest.mark.parametrize("module,name", INDEX_CLASSES)
def test_index_takes_the_reference_keywords_in_order(module, name):
    ref, port = _classes(module, name)
    want = [p.name for p in _params(ref.__init__)]
    got = [p.name for p in _params(port.__init__)]
    assert got[:len(want)] == want


@pytest.mark.parametrize("module,name", INDEX_CLASSES)
def test_index_builds_with_the_reference_keyword_set(module, name):
    ref, port = _classes(module, name)
    kw = _full_keywords(ref)
    assert {"recall_target", "search_mode"} <= set(kw)
    dim = 256 if "proj_dim" in kw else 64
    kw.update(dimension=dim, device="cpu", initial_capacity=256, recall_target=0.5)
    if "proj_dim" in kw:
        kw["proj_dim"] = 128
    if "use_pallas" in kw:
        kw["use_pallas"] = True
    idx = port(**kw)
    g = np.random.default_rng(0)
    v = g.standard_normal((300, dim)).astype(np.float32)
    idx.add_batch([f"d{i}" for i in range(len(v))], v)
    hits = idx.search_batch(v[:3], 5)
    assert len(hits) == 3 and all(len(row) == 5 for row in hits)


def test_positional_device_binds_device():
    """The port's flat ``device`` is the reference's 8th parameter."""
    _, port = _classes("flat", "FlatDeviceIndex")
    idx = port(64, "cosine", "bfloat16", 256, 2, "exact", 0.99, "cpu")
    assert idx.device.type == "cpu" and idx.recall_target == 0.99


@pytest.mark.parametrize("name", list(jops.__all__))
def test_ops_exports_every_reference_name(name):
    got = getattr(tops, name)
    assert name in tops.__all__
    want = [p.name for p in _params(getattr(jops, name))]
    assert [p.name for p in _params(got)][:len(want)] == want


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_l2_normalize_takes_axis(axis):
    x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    got = tdist.l2_normalize(torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_allclose(got, np.asarray(jdist.l2_normalize(jnp.asarray(x), axis=axis)),
                               rtol=0, atol=1e-6)
    if axis in (1, -1):
        assert np.array_equal(got, tdist.l2_normalize(torch.from_numpy(x)).numpy())


def test_scored_topk_ignores_recall_target():
    g = np.random.default_rng(2)
    v = torch.from_numpy(g.standard_normal((500, 32)).astype(np.float32))
    q = torch.from_numpy(g.standard_normal((4, 32)).astype(np.float32))
    norms = torch.linalg.vector_norm(v, dim=1)
    valid = torch.ones(500, dtype=torch.bool)
    mask = torch.from_numpy(g.random(500) < 0.5)
    plain = tdist.scored_topk(q, v, norms, valid, 7, mask=mask)
    for got in (tdist.scored_topk(q, v, norms, valid, 7, mask=mask, recall_target=0.5),
                tdist.scored_topk(q, v, norms, valid, 7, "cosine", 65536, "approx", 0.5,
                                  mask)):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])

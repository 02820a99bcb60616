"""The port's public surface matches the reference's, on the CPU.

- Every index class of the port takes the reference class's keywords, in the
  reference's order (a positional call binds the same parameter in both
  packages); the port may add trailing keywords. ``recall_target`` and
  ``use_pallas`` are accepted and ignored: the port's selections are exact
  and it has no Pallas.
- ``grape_vector_db_tpu_torch.ops`` exports every name of the reference's
  ``ops.__all__``, with the reference's parameters in its order; so does
  every other module the two packages share (same path), the sharded
  ``parallel`` package, ``ops/ivf_scan.py`` and ``index/ivf_proj.py``
  among them.
- ``l2_normalize(..., axis=)`` and ``scored_topk(..., recall_target=)`` give
  what the calls without the keyword give.
"""

import importlib
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grape_vector_db_tpu.ops as jops
import grape_vector_db_tpu_torch.ops as tops
from grape_vector_db_tpu.ops import distance as jdist
from grape_vector_db_tpu_torch.ops import distance as tdist

# (module under index/, or a dotted path under the package, class) present
# in both packages
INDEX_CLASSES = [
    ("flat", "FlatDeviceIndex"), ("binary", "BinaryDeviceIndex"),
    ("int8", "Int8DeviceIndex"), ("pq", "PqDeviceIndex"), ("ivf", "IvfDeviceIndex"),
    ("ivf_int8", "Int8IvfDeviceIndex"), ("ivf_int4", "Int4IvfDeviceIndex"),
    ("ivf_pq", "IvfPqDeviceIndex"), ("ivf_proj", "ProjectedInt8IvfIndex"),
    ("ivf_proj", "ProjectedInt4IvfIndex"), ("graph", "GraphDeviceIndex"),
    ("parallel.mesh", "ShardedFlatIndex"), ("parallel.mesh", "ShardedIvfIndex"),
    ("parallel.mesh", "ShardedInt8IvfIndex"), ("parallel.mesh", "ShardedInt4IvfIndex"),
    ("ivf_proj", "ShardedProjectedInt8IvfIndex"), ("ivf_proj", "ShardedProjectedInt4IvfIndex"),
]
_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _classes(module, name):
    path = module if "." in module else f"index.{module}"
    ref = getattr(importlib.import_module(f"grape_vector_db_tpu.{path}"), name)
    port = getattr(importlib.import_module(f"grape_vector_db_tpu_torch.{path}"), name)
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
    kw.update(dimension=dim, device="cpu", recall_target=0.5)
    kw["initial_capacity" if "initial_capacity" in kw else "shard_capacity"] = 256
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


def _shared_modules():
    """Dotted module names (under each package) that both packages have."""
    found = []
    for pkg in ("grape_vector_db_tpu", "grape_vector_db_tpu_torch"):
        names = set()
        for root, _, files in os.walk(os.path.join(_REPO, pkg)):
            for f in files:
                if f.endswith(".py"):
                    rel = os.path.relpath(os.path.join(root, f), os.path.join(_REPO, pkg))
                    names.add(rel[:-3].replace(os.sep, ".").removesuffix("__init__")
                              .rstrip("."))
        found.append(names)
    return sorted(found[0] & found[1])


def _is_function(obj) -> bool:
    """A plain function, or a jitted one (which keeps it as ``__wrapped__``)."""
    return inspect.isfunction(obj) or (callable(obj) and not inspect.isclass(obj)
                                       and inspect.isfunction(getattr(obj, "__wrapped__", None)))


@pytest.mark.parametrize("module", _shared_modules())
def test_module_exports_match_the_reference(module):
    """Every name of a shared module's reference ``__all__`` is in the
    port's, and each such function takes the reference's parameters in its
    order (the port may add trailing ones)."""
    suffix = f".{module}" if module else ""
    ref = importlib.import_module(f"grape_vector_db_tpu{suffix}")
    port = importlib.import_module(f"grape_vector_db_tpu_torch{suffix}")
    want_all = getattr(ref, "__all__", None)
    if want_all is None:
        return
    missing = [n for n in want_all if n not in getattr(port, "__all__", ())]
    assert not missing, f"{module}: the port's __all__ lacks {missing}"
    for name in want_all:
        r, p = getattr(ref, name), getattr(port, name)
        if _is_function(r):
            want = [x.name for x in _params(r)]
            assert [x.name for x in _params(p)][:len(want)] == want, f"{module}.{name}"


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

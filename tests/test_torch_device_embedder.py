"""The port's DeviceHashEmbedder against the JAX package's, on the CPU.

- Featurization (bucket ids and signed weights) is bit-equal to the
  reference's, through the native loop and the Python route, on ASCII and
  non-ASCII text.
- The device step agrees within 1e-5 absolute on the f32 rows (the same bf16
  products, summed in another order) and within one f16 ulp on the f16 rows
  the store keeps (an f32 row a few 1e-8 apart may round to the neighbouring
  f16).
- The reference file's cases (tests/test_device_embedder.py), through the
  port with ``device="cpu"``.
- An embedder made for ``"cuda"`` raises when it embeds on a host without a
  card; it never runs on the CPU instead.
"""

import numpy as np
import pytest
import torch

import grape_vector_db_tpu.services.device_embedder as jmod
import grape_vector_db_tpu_torch.services.device_embedder as tmod
from grape_vector_db_tpu.services.device_embedder import DeviceHashEmbedder as JaxEmbedder
from grape_vector_db_tpu_torch import Document, SearchRequest, VectorDatabase, VectorDbConfig
from grape_vector_db_tpu_torch.services.device_embedder import DeviceHashEmbedder
from grape_vector_db_tpu_torch.services.embeddings import create_provider

torch.set_num_threads(2)

F32_TOL = 1e-5

WORDS = ["alpha", "beta", "the", "microbatching", "x1", "a_b", "zz", "tokenization", "and",
         "q", "replication", "consensus", "vector"]


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    out = [" ".join(WORDS[int(j)] for j in rng.integers(0, len(WORDS), int(rng.integers(1, 30))))
           for _ in range(n)]
    return out + ["", "   ", "the and of", "UPPER Case MIX 123", "_", "<>", "a" * 300,
                  ("word " * 100).strip(), "中文 内容 ascii", "naïve café", "Ünïcödé ß straße"]


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _python_route(monkeypatch):
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod, "_HASH_LIB", None)
        monkeypatch.setattr(mod, "_HASH_LIB_READY", True)


@pytest.mark.parametrize("route", ["native", "python"])
def test_featurization_bit_equal_to_reference(route, monkeypatch):
    if route == "native":
        if tmod._native_hash_lib() is None or jmod._native_hash_lib() is None:
            pytest.skip("native toolchain unavailable")
    else:
        _python_route(monkeypatch)
    texts = _texts(120)
    kw = dict(dim=32, buckets=4096, seed=7, max_features=64)
    ji, jv = JaxEmbedder(**kw)._featurize(texts)
    ti, tv = DeviceHashEmbedder(**kw, device="cpu")._featurize(texts)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


def test_native_featurizer_exact_parity(monkeypatch):
    """The C++ loop reproduces the port's Python featurizer bit for bit on
    ASCII text; non-ASCII rows of a mixed batch route through Python."""
    if tmod._native_hash_lib() is None:
        pytest.skip("native toolchain unavailable")
    emb = DeviceHashEmbedder(dim=32, buckets=4096, seed=7, max_features=64, device="cpu")
    texts = _texts(200, seed=1)
    idx_n, val_n = emb._featurize(texts)
    monkeypatch.setattr(tmod, "_HASH_LIB", None)
    monkeypatch.setattr(tmod, "_HASH_LIB_READY", True)
    idx_p, val_p = emb._featurize(texts)
    np.testing.assert_array_equal(idx_n, idx_p)
    np.testing.assert_array_equal(val_n, val_p)


def _f16_ulps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of the f16 spacing at the larger magnitude."""
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float16)
    return np.abs(a.astype(np.float32) - b.astype(np.float32)) / np.spacing(big).astype(np.float32)


@pytest.mark.parametrize("dim,buckets,chunk,n", [(128, 4096, 1024, 40), (96, 2048, 8, 21),
                                                 (768, 32768, 1024, 9)])
def test_embedding_matches_reference(dim, buckets, chunk, n):
    texts = _texts(n, seed=dim)[:n]
    jemb = JaxEmbedder(dim=dim, buckets=buckets, chunk=chunk)
    temb = DeviceHashEmbedder(dim=dim, buckets=buckets, chunk=chunk, device="cpu")
    jchunks, jdrain = jemb.embed_ingest(texts)
    tchunks, tdrain = temb.embed_ingest(texts)
    assert [nv for _, nv in tchunks] == [nv for _, nv in jchunks]
    for (jt, nv), (tt, _) in zip(jchunks, tchunks):
        assert tt.dtype == torch.float32 and tt.shape[1] == dim and tt.device.type == "cpu"
        np.testing.assert_allclose(tt[:nv].numpy(), np.asarray(jt)[:nv], rtol=0, atol=F32_TOL)
    j16, t16 = jdrain(), tdrain()
    assert t16.dtype == np.float16 and t16.shape == (len(texts), dim)
    assert _f16_ulps_apart(t16, j16).max() <= 1.0
    np.testing.assert_array_equal(temb.embed_array(texts), t16.astype(np.float32))


def test_embedder_made_for_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    emb = DeviceHashEmbedder(dim=32, buckets=512, device="cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        emb.embed_array(["some text"])


def test_deterministic_across_instances():
    a = DeviceHashEmbedder(dim=128, buckets=4096, device="cpu")
    b = DeviceHashEmbedder(dim=128, buckets=4096, device="cpu")
    np.testing.assert_array_equal(a.embed_array(["the quick brown fox jumps"])[0],
                                  b.embed_array(["the quick brown fox jumps"])[0])


def test_unit_norm_and_shape():
    emb = DeviceHashEmbedder(dim=96, buckets=2048, device="cpu")
    out = emb.embed_array(["alpha beta gamma", "delta", ""])
    assert out.shape == (3, 96) and out.dtype == np.float32
    assert abs(np.linalg.norm(out[0]) - 1.0) < 1e-3
    # empty text has no features -> zero vector (cosine 0 vs everything)
    assert np.linalg.norm(out[2]) < 1e-6


def test_lexical_similarity_structure():
    emb = DeviceHashEmbedder(dim=256, buckets=8192, device="cpu")
    v = emb.embed_array([
        "distributed vector database with raft consensus replication",
        "a distributed vector database using raft consensus",   # near-dup
        "chocolate cake recipe with vanilla frosting sugar",    # unrelated
    ])
    near, far = _cos(v[0], v[1]), _cos(v[0], v[2])
    assert near > 0.5, f"near-duplicate texts should be similar, got {near}"
    assert near > far + 0.2, f"similarity must track lexical overlap ({near} vs {far})"


def test_subword_robustness():
    emb = DeviceHashEmbedder(dim=256, buckets=8192, device="cpu")
    v = emb.embed_array(["replication manager", "replicating managers", "zebra quartz flux"])
    assert _cos(v[0], v[1]) > _cos(v[0], v[2])


def test_seed_changes_space():
    va = DeviceHashEmbedder(dim=128, buckets=4096, seed=0, device="cpu").embed_array(
        ["same text"])[0]
    vb = DeviceHashEmbedder(dim=128, buckets=4096, seed=1, device="cpu").embed_array(
        ["same text"])[0]
    assert _cos(va, vb) < 0.9


def test_generate_embeddings_matches_array():
    emb = DeviceHashEmbedder(dim=64, buckets=1024, device="cpu")
    lists = emb.generate_embeddings(["hello world"])
    np.testing.assert_allclose(np.asarray(lists[0], np.float32),
                               emb.embed_array(["hello world"])[0], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 17])
def test_batch_padding_consistency(n):
    # chunking the batch must not change per-text results
    emb = DeviceHashEmbedder(dim=64, buckets=1024, chunk=8, device="cpu")
    texts = [f"document number {i} about topic {i % 3}" for i in range(n)]
    batch = emb.embed_array(texts)
    for i, t in enumerate(texts):
        np.testing.assert_allclose(batch[i], emb.embed_array([t])[0], atol=1e-5)


def _device_cfg(cache=True):
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.embedding.provider = "device"
    cfg.embedding.hash_buckets = 4096
    cfg.index.initial_capacity = 64
    cfg.cache.enabled = cache
    return cfg


def test_factory_and_db_integration():
    cfg = _device_cfg()
    prov = create_provider(cfg.embedding, device="cpu")
    assert isinstance(prov, DeviceHashEmbedder) and prov.device.type == "cpu"
    assert isinstance(create_provider(cfg.embedding), DeviceHashEmbedder)  # "cuda" by default
    db = VectorDatabase(config=cfg, device="cpu")
    try:
        assert db.embedder.inner.device.type == "cpu"
        db.batch_add_documents([
            Document(id="raft", content="raft consensus leader election log"),
            Document(id="ivf", content="inverted file coarse quantizer probe"),
            Document(id="cake", content="chocolate cake vanilla frosting"),
        ])
        rec = db.store.get("raft")
        assert rec is not None and rec.embedding is not None
        res = db.search(SearchRequest(query="raft leader election", limit=1))
        assert res and res[0].document.id == "raft"
        res = db.search(SearchRequest(query="chocolate frosting", limit=1))
        assert res and res[0].document.id == "cake"
    finally:
        db.close()


def test_db_integration_cache_disabled_unwrap():
    db = VectorDatabase(config=_device_cfg(cache=False), device="cpu")
    try:
        assert isinstance(db.embedder, DeviceHashEmbedder)
        db.batch_add_documents([Document(id="a", content="alpha beta gamma")])
        res = db.search(SearchRequest(query="alpha beta", limit=1))
        assert res and res[0].document.id == "a"
    finally:
        db.close()


def test_device_direct_ingest_parity_and_fallbacks(monkeypatch):
    """Text-only batches with unique ids take ``add_batch_device`` and store
    the f16 rows; mixed batches and batches with duplicate ids take the host
    path (``add_batch``), as the reference pins."""
    from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex

    calls = {"device": 0, "host": 0}
    dev_fn, host_fn = FlatDeviceIndex.add_batch_device, FlatDeviceIndex.add_batch

    def dev(self, *a, **k):
        calls["device"] += 1
        return dev_fn(self, *a, **k)

    def host(self, *a, **k):
        calls["host"] += 1
        return host_fn(self, *a, **k)

    monkeypatch.setattr(FlatDeviceIndex, "add_batch_device", dev)
    monkeypatch.setattr(FlatDeviceIndex, "add_batch", host)
    db = VectorDatabase(config=_device_cfg(cache=False), device="cpu")
    try:
        texts = [f"theme {i % 5} document body number {i}" for i in range(33)]
        db.batch_add_documents([Document(id=f"t{i}", content=texts[i]) for i in range(33)])
        assert calls == {"device": 1, "host": 0}
        ref = db.embedder.embed_array(texts)
        for i in (0, 7, 32):
            emb = np.asarray(db.store.get(f"t{i}").embedding, np.float32)
            np.testing.assert_array_equal(emb, ref[i])
            # the index row is the bf16 cast of the device f32 row
            np.testing.assert_allclose(db.index.get_vector(f"t{i}"), ref[i], atol=8e-3)
        res = db.search(SearchRequest(query=texts[7], limit=1))
        assert res and res[0].document.id == "t7"
        v = np.zeros(128, np.float32)
        v[0] = 1.0
        db.batch_add_documents([
            Document(id="mix_v", content="has a vector", vector=v),
            Document(id="mix_t", content="unique zebra xylophone text"),
        ])
        assert calls == {"device": 1, "host": 1}
        res = db.search(SearchRequest(query="unique zebra xylophone", limit=1))
        assert res and res[0].document.id == "mix_t"
        db.batch_add_documents([
            Document(id="dup", content="first version of the dup doc"),
            Document(id="dup", content="second version wins the slot"),
        ])
        assert calls == {"device": 1, "host": 2}
        assert db.store.get("dup").content == "second version wins the slot"
        assert len(db.index) == 33 + 2 + 1
    finally:
        db.close()

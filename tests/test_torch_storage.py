"""The file and native stores through both packages, and their files across.

- The reference's tests/test_storage.py and tests/test_native_store.py
  cases, each run through the JAX package and through the port.
- Files cross both ways where zstandard imports: a data directory, a backup
  and an index snapshot written by one package open in the other with the
  same documents.
- The zlib route, with zstandard hidden: the port writes and reads it; a
  zstd file then raises ``StorageError``.
"""

import os
import sys
import types

import msgpack
import numpy as np
import pytest
import zstandard

import grape_vector_db_tpu.storage as jstorage
import grape_vector_db_tpu.storage.file as jfile
import grape_vector_db_tpu.storage.native as jnative
import grape_vector_db_tpu.types as jtypes
import grape_vector_db_tpu_torch.storage as tstorage
import grape_vector_db_tpu_torch.storage.file as tfile
import grape_vector_db_tpu_torch.storage.native as tnative
import grape_vector_db_tpu_torch.types as ttypes
from grape_vector_db_tpu.errors import BackupError as JaxBackupError
from grape_vector_db_tpu_torch.errors import BackupError, StorageError

PKGS = {
    "jax": types.SimpleNamespace(storage=jstorage, file=jfile, native=jnative, types=jtypes,
                                 BackupError=JaxBackupError, db_kwargs={}),
    "torch": types.SimpleNamespace(storage=tstorage, file=tfile, native=tnative, types=ttypes,
                                   BackupError=BackupError, db_kwargs={"device": "cpu"}),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def mkrec(pkg, i, dim=8):
    return pkg.types.DocumentRecord(
        id=f"doc-{i}",
        content=f"content number {i}",
        title=f"title {i}",
        embedding=list(np.arange(dim, dtype=np.float32) + i),
        metadata={"category": "a" if i % 2 == 0 else "b", "rank": i},
    )


# -- tests/test_storage.py ----------------------------------------------------------


def test_memory_store_crud(pkg):
    s = pkg.storage.MemoryDocumentStore()
    s.batch_insert([mkrec(pkg, i) for i in range(10)])
    assert s.count() == 10
    assert s.get("doc-3").title == "title 3"
    assert s.batch_delete(["doc-3", "doc-404"]) == 1
    assert s.count() == 9
    assert s.get("doc-3") is None


def test_file_store_wal_replay(pkg, tmp_path):
    d = str(tmp_path / "db")
    s = pkg.storage.FileDocumentStore(d)
    s.batch_insert([mkrec(pkg, i) for i in range(50)])
    s.batch_delete(["doc-0", "doc-1"])
    s.put_kv("raft_state_term", b"\x07")
    s.flush()
    s2 = pkg.storage.FileDocumentStore(d)
    assert s2.count() == 48
    assert s2.get("doc-10").content == "content number 10"
    assert s2.get_kv("raft_state_term") == b"\x07"
    np.testing.assert_allclose(s2.get("doc-10").embedding, mkrec(pkg, 10).embedding)
    s.close()
    s2.close()


def test_file_store_compaction_and_reopen(pkg, tmp_path):
    d = str(tmp_path / "db")
    s = pkg.storage.FileDocumentStore(d)
    s.batch_insert([mkrec(pkg, i) for i in range(30)])
    s.compact()
    assert os.path.getsize(os.path.join(d, "wal.gvdb")) == 0
    s.close()
    s3 = pkg.storage.FileDocumentStore(d)
    assert s3.count() == 30
    s3.close()


def test_backup_restore_roundtrip(pkg, tmp_path):
    d = str(tmp_path / "db")
    bak = str(tmp_path / "backups" / "b1.gvdb")
    s = pkg.storage.FileDocumentStore(d)
    s.batch_insert([mkrec(pkg, i) for i in range(25)])
    info = s.create_backup(bak)
    assert info["count"] == 25 and os.path.exists(bak)
    s.batch_delete([f"doc-{i}" for i in range(20)])
    assert s.count() == 5
    out = s.restore_backup(bak)
    assert s.count() == 25
    assert os.path.exists(out["pre_restore_backup"])
    s.close()


def test_backup_checksum_verification(pkg, tmp_path):
    bak = str(tmp_path / "b.gvdb")
    s = pkg.storage.FileDocumentStore(str(tmp_path / "db"))
    s.batch_insert([mkrec(pkg, 1)])
    s.create_backup(bak)
    with open(bak, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x00")
    with pytest.raises(pkg.BackupError):
        s.restore_backup(bak)
    s.close()


def test_torn_wal_tail_recovery(pkg, tmp_path):
    d = str(tmp_path / "db")
    s = pkg.storage.FileDocumentStore(d)
    s.batch_insert([mkrec(pkg, i) for i in range(5)])
    s.flush()
    s.close()
    with open(os.path.join(d, "wal.gvdb"), "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial")
    s2 = pkg.storage.FileDocumentStore(d)
    assert s2.count() == 5
    s2.close()


# -- tests/test_native_store.py -------------------------------------------------------


def test_kv_crud(pkg, tmp_path):
    kv = pkg.native.NativeKV(str(tmp_path / "t.db"))
    kv.put(b"a", b"1")
    kv.put(b"b", b"22")
    assert kv.get(b"a") == b"1"
    assert kv.get(b"missing") is None
    kv.put(b"a", b"111")
    assert kv.get(b"a") == b"111"
    assert kv.count() == 2
    assert kv.delete(b"a")
    assert not kv.delete(b"a")
    assert kv.get(b"a") is None
    assert sorted(kv.keys()) == [b"b"]
    kv.close()


def test_kv_reopen_and_torn_tail(pkg, tmp_path):
    p = str(tmp_path / "t.db")
    kv = pkg.native.NativeKV(p)
    for i in range(100):
        kv.put(f"k{i}".encode(), f"v{i}".encode() * 10)
    kv.delete(b"k5")
    kv.flush()
    kv.close()
    with open(p, "ab") as f:
        f.write(b"\x10\x00\x00\x00\x20\x00\x00\x00partial")
    kv2 = pkg.native.NativeKV(p)
    assert kv2.count() == 99
    assert kv2.get(b"k7") == b"v7" * 10
    assert kv2.get(b"k5") is None
    kv2.put(b"after", b"crash")
    kv2.close()
    kv3 = pkg.native.NativeKV(p)
    assert kv3.get(b"after") == b"crash"
    kv3.close()


def test_kv_compaction_reclaims(pkg, tmp_path):
    p = str(tmp_path / "t.db")
    kv = pkg.native.NativeKV(p)
    for _ in range(50):
        kv.put(b"same", b"x" * 1000)
    assert kv.dead_bytes > 40_000
    size_before = os.path.getsize(p)
    kv.compact()
    kv.flush()
    assert kv.dead_bytes == 0
    assert os.path.getsize(p) < size_before / 10
    assert kv.get(b"same") == b"x" * 1000
    kv.close()


def test_native_document_store(pkg, tmp_path):
    s = pkg.native.NativeDocumentStore(str(tmp_path / "nds"))
    s.batch_insert([mkrec(pkg, i) for i in range(30)])
    assert s.count() == 30
    rec = s.get("doc-4")
    assert rec.content == "content number 4"
    np.testing.assert_allclose(rec.embedding, mkrec(pkg, 4).embedding)
    assert s.batch_delete(["doc-4", "nope"]) == 1
    s.put_kv("raft_state_x", b"\x01\x02")
    assert s.get_kv("raft_state_x") == b"\x01\x02"
    assert dict(s.iter_kv_prefix("raft_"))["raft_state_x"] == b"\x01\x02"
    hits = s.vector_search(mkrec(pkg, 7).embedding, limit=3)
    assert hits[0].id == "doc-7"
    s.close()


def test_native_backup_restorable_by_memory_store(pkg, tmp_path):
    s = pkg.native.NativeDocumentStore(str(tmp_path / "nds"))
    s.batch_insert([mkrec(pkg, i) for i in range(10)])
    bak = str(tmp_path / "b.gvdb")
    assert s.create_backup(bak)["count"] == 10
    mem = pkg.storage.MemoryDocumentStore()
    mem.restore_backup(bak)
    assert mem.count() == 10
    assert mem.get("doc-3").content == "content number 3"
    s.close()


def test_native_behind_vector_database(pkg, tmp_path):
    import grape_vector_db_tpu as jax_pkg
    import grape_vector_db_tpu_torch as torch_pkg

    top = jax_pkg if pkg is PKGS["jax"] else torch_pkg
    cfg = top.VectorDbConfig(vector_dimension=16)
    cfg.device.storage_dtype = "float32"
    cfg.index.initial_capacity = 128
    db = top.VectorDatabase(config=cfg, store=pkg.native.NativeDocumentStore(
        str(tmp_path / "ndb")), **pkg.db_kwargs)
    rng = np.random.default_rng(0)
    docs = [top.Document(id=f"n{i}", content=f"c{i}",
                         vector=rng.standard_normal(16).astype(np.float32).tolist())
            for i in range(40)]
    db.batch_add_documents(docs)
    assert db.vector_search(top.SearchRequest(vector=docs[8].vector, limit=3))[0].id == "n8"
    db.close()
    db2 = top.VectorDatabase(config=cfg, store=pkg.native.NativeDocumentStore(
        str(tmp_path / "ndb")), **pkg.db_kwargs)
    assert db2.vector_search(top.SearchRequest(vector=docs[8].vector, limit=1))[0].id == "n8"
    db2.close()


def test_port_builds_native_store_in_its_own_build_dir():
    so = tnative._build_lib()
    assert os.path.dirname(so) == os.path.abspath(
        os.path.join(os.path.dirname(tnative.__file__), "..", "_build"))
    assert os.path.exists(so)


# -- files across the packages ------------------------------------------------------------


def _fill(pkg, d, n=40):
    s = pkg.storage.FileDocumentStore(d)
    s.batch_insert([mkrec(pkg, i) for i in range(n)])
    s.put_kv("raft_state_term", b"\x09")
    return s


def _same_docs(a, b):
    assert sorted(a.iter_ids()) == sorted(b.iter_ids())
    for i in a.iter_ids():
        da, db_ = a.get(i).to_dict(), b.get(i).to_dict()
        # the port decodes an embedding to an f32 ndarray, the JAX package
        # to a list of floats: the same f32 values, compared bit for bit
        ea, eb = da.pop("embedding"), db_.pop("embedding")
        assert da == db_
        assert (ea is None) == (eb is None)
        if ea is not None:
            assert (np.asarray(ea, np.float32).tobytes()
                    == np.asarray(eb, np.float32).tobytes())


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("compact", [False, True])
def test_data_directory_crosses(tmp_path, writer, reader, compact):
    """WAL frames (compact=False) and the snapshot (compact=True)."""
    d = str(tmp_path / "db")
    s = _fill(PKGS[writer], d)
    s.batch_delete(["doc-3"])
    s.flush()
    if compact:
        s.close()
    r = PKGS[reader].storage.FileDocumentStore(d)
    assert r.count() == 39 and r.get("doc-3") is None
    assert r.get_kv("raft_state_term") == b"\x09"
    _same_docs(r, s)
    r.close()
    if not compact:
        s.close()


@pytest.mark.parametrize("compact", [False, True])
def test_port_decodes_embeddings_to_f32_arrays(tmp_path, compact):
    """The port's decoded records hold their embedding as a writable f32
    ndarray (as the ingest path leaves it), with the stored values."""
    torch_pkg = PKGS["torch"]
    s = _fill(torch_pkg, str(tmp_path / "db"), n=6)
    s.flush()
    if compact:
        s.close()
    r = tfile.FileDocumentStore(str(tmp_path / "db"))
    for i in range(6):
        emb = r.get(f"doc-{i}").embedding
        assert isinstance(emb, np.ndarray) and emb.dtype == np.float32 and emb.flags.writeable
        np.testing.assert_array_equal(emb, np.float32(mkrec(torch_pkg, i).embedding))
    r.close()
    if not compact:
        s.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_backup_crosses(tmp_path, writer, reader):
    s = _fill(PKGS[writer], str(tmp_path / "a"))
    bak = str(tmp_path / "b.gvdb")
    s.create_backup(bak)
    r = PKGS[reader].storage.FileDocumentStore(str(tmp_path / "b"))
    r.restore_backup(bak)
    _same_docs(r, s)
    s.close()
    r.close()


def test_port_files_are_the_reference_bytes(tmp_path):
    """With zstandard the port writes a store payload as the reference
    does: its magic, then a zstd frame of msgpack's bytes."""
    recs = [mkrec(PKGS["torch"], i) for i in range(5)]
    blob = tfile.encode_store_payload(recs, {"k": b"v"})
    assert blob[:8] == b"GVDBTPU1" and blob[8:12] == b"\x28\xb5\x2f\xfd"
    payload = msgpack.unpackb(zstandard.ZstdDecompressor().decompress(blob[8:]), raw=False)
    raw = zstandard.ZstdDecompressor().decompress(blob[8:])
    assert msgpack.packb(payload, use_bin_type=True) == raw
    docs, kv = jfile.decode_store_payload(blob)
    assert kv == {"k": b"v"} and sorted(docs) == [f"doc-{i}" for i in range(5)]


# -- the zlib route ---------------------------------------------------------------------------


@pytest.fixture
def no_zstd(monkeypatch):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    assert tfile._zstandard() is None


def test_zlib_route_roundtrip(tmp_path, no_zstd, monkeypatch):
    pkg = PKGS["torch"]
    monkeypatch.setattr(tfile, "_ZLIB_CHUNK", 1000)   # several streams
    d = str(tmp_path / "db")
    s = _fill(pkg, d)
    bak = str(tmp_path / "b.gvdb")
    s.create_backup(bak)
    s.close()
    with open(os.path.join(d, "snapshot.gvdb"), "rb") as f:
        assert f.read(8) == b"GVDBZLB1"
    r = pkg.storage.FileDocumentStore(d)
    assert r.count() == 40 and r.get_kv("raft_state_term") == b"\x09"
    r.batch_delete([f"doc-{i}" for i in range(30)])
    r.restore_backup(bak)
    assert r.count() == 40
    np.testing.assert_allclose(r.get("doc-7").embedding, mkrec(pkg, 7).embedding)
    r.close()


@pytest.mark.parametrize("n", [0, 1, 999, 1000, 1001, 5000])
def test_zlib_blob_roundtrip(no_zstd, monkeypatch, n):
    monkeypatch.setattr(tfile, "_ZLIB_CHUNK", 1000)
    raw = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8).tobytes()
    blob = tfile.compress(raw, 3)
    assert blob[:8] == b"GVDBZLB1"
    assert tfile.decompress(blob) == raw


def test_zstd_file_without_zstandard_raises(tmp_path, monkeypatch):
    d = str(tmp_path / "db")
    _fill(PKGS["jax"], d).close()                    # a zstd snapshot
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(StorageError):
        tstorage.FileDocumentStore(d)
    with pytest.raises(StorageError):
        tfile.decompress(zstandard.ZstdCompressor().compress(b"abc"))

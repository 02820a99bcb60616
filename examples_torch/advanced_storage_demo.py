"""Advanced storage demo on the PyTorch + CUDA port (reference
examples/advanced_storage_demo.rs): the durable store behind the database:
WAL + snapshot compaction, checksummed atomic backup/restore, the KV
namespace raft persistence rides on, and the native C++ segment-log engine
when built. The store lives on the host, so this demo takes no device.

Run: python examples_torch/advanced_storage_demo.py
"""

import os
import tempfile

import numpy as np

from grape_vector_db_tpu_torch.storage.file import FileDocumentStore
from grape_vector_db_tpu_torch.types import DocumentRecord


def record(i: int) -> DocumentRecord:
    rng = np.random.default_rng(i)
    return DocumentRecord(
        id=f"doc-{i}", content=f"content body {i}",
        embedding=rng.standard_normal(32).astype(np.float32).tolist(),
        metadata={"i": i},
    )


def main(data_dir: str | None = None) -> dict:
    root = data_dir or tempfile.mkdtemp(prefix="gvdb_storage_")
    path = os.path.join(root, "store")

    # ---- WAL + snapshot -------------------------------------------------------
    store = FileDocumentStore(path)
    store.batch_insert([record(i) for i in range(200)])
    store.batch_delete([f"doc-{i}" for i in range(10)])
    print("count:", store.count())
    store.compact()  # fold the WAL into a snapshot
    stats = store.get_stats()
    print(f"stats: docs={stats.document_count} bytes~{stats.estimated_size_bytes}")

    # ---- KV namespace (what raft state/log persistence uses) ------------------
    store.put_kv("raft_state_alpha", b"term=3;voted=beta")
    assert store.get_kv("raft_state_alpha") == b"term=3;voted=beta"

    # ---- checksummed atomic backup / restore -----------------------------------
    backup = os.path.join(root, "backup.gvdb")
    meta = store.create_backup(backup)
    print("backup:", {k: meta[k] for k in ("count", "sha256") if k in meta})
    store.batch_delete([f"doc-{i}" for i in range(10, 60)])
    assert store.count() == 140
    store.restore_backup(backup)
    assert store.count() == 190, store.count()
    print("restore verified:", store.count())

    # ---- crash recovery: reopen replays WAL ------------------------------------
    store.batch_insert([record(1000)])
    store.close()
    reopened = FileDocumentStore(path)
    assert reopened.get("doc-1000") is not None
    print("reopen (WAL replay) OK; count:", reopened.count())
    out = {"restored": 190, "reopened": reopened.count()}
    reopened.close()

    # ---- native C++ engine (when the toolchain built it) -----------------------
    from grape_vector_db_tpu_torch.storage.native import native_available

    if native_available():
        from grape_vector_db_tpu_torch.storage.native import NativeDocumentStore

        npath = os.path.join(root, "native")
        ns = NativeDocumentStore(npath)
        ns.batch_insert([record(i) for i in range(50)])
        print("native C++ store count:", ns.count())
        out["native"] = ns.count()
        ns.close()
    else:
        print("native C++ store not built; skipped")
    print("advanced_storage_demo OK")
    return out


if __name__ == "__main__":
    main()

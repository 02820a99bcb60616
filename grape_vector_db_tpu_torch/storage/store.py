"""DocumentStore — the VectorStore trait of the new framework.

Mirrors the reference's 19-method async ``VectorStore`` trait (storage.rs:25-121)
as a sync host-side interface (the embedded layer adds async/blocking facades).
``MemoryDocumentStore`` is the in-process reference implementation; its
vector_search / text_search / hybrid_search reproduce BasicVectorStore's
full-scan semantics (storage.rs:296-435) and serve as the oracle the device
index layer is tested against. Production search goes through the query engine
+ device indexes; these store-level scans exist for parity and fallback.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu_torch.errors import NotFoundError
from grape_vector_db_tpu_torch.types import DocumentRecord, ScoredPoint

__all__ = ["StorageStats", "DocumentStore", "MemoryDocumentStore", "cosine_similarity"]


def cosine_similarity(a: Sequence[float], b: Sequence[float]) -> float:
    """storage.rs:851-865."""
    av, bv = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    na, nb = np.linalg.norm(av), np.linalg.norm(bv)
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(av @ bv / (na * nb))


@dataclass
class StorageStats:
    """advanced_storage.rs:63-72 StorageStats."""

    document_count: int = 0
    estimated_size_bytes: int = 0
    cache_hit_rate: float = 0.0
    compression_ratio: float = 1.0
    last_backup_time: Optional[int] = None
    last_flush_time: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)


class DocumentStore:
    """Abstract store of DocumentRecords keyed by id."""

    # -- CRUD ------------------------------------------------------------------
    def insert(self, record: DocumentRecord) -> None:
        self.batch_insert([record])

    def batch_insert(self, records: Sequence[DocumentRecord]) -> None:
        raise NotImplementedError

    def get(self, id_: str) -> Optional[DocumentRecord]:
        raise NotImplementedError

    def batch_get(self, ids: Sequence[str]) -> List[Optional[DocumentRecord]]:
        return [self.get(i) for i in ids]

    def delete(self, id_: str) -> bool:
        return self.batch_delete([id_]) == 1

    def batch_delete(self, ids: Sequence[str]) -> int:
        raise NotImplementedError

    def contains(self, id_: str) -> bool:
        return self.get(id_) is not None

    def count(self) -> int:
        raise NotImplementedError

    def iter_ids(self) -> Iterable[str]:
        raise NotImplementedError

    def iter_records(self) -> Iterable[DocumentRecord]:
        for i in list(self.iter_ids()):
            r = self.get(i)
            if r is not None:
                yield r

    def list_page(self, offset: int, limit: int) -> List[DocumentRecord]:
        """Paginated scan (the reference paginates 500/page, hybrid.rs:619-671)."""
        ids = sorted(self.iter_ids())
        return [r for r in self.batch_get(ids[offset:offset + limit]) if r is not None]

    def clear(self) -> None:
        raise NotImplementedError

    # -- generic KV (used by Raft persistence, advanced_storage.rs:627-651) -----
    def put_kv(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get_kv(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete_kv(self, key: str) -> bool:
        raise NotImplementedError

    def iter_kv_prefix(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        raise NotImplementedError

    # -- store-level search (full-scan parity with storage.rs:296-435) ----------
    def vector_search(self, query: Sequence[float], limit: int,
                      threshold: float = 0.0) -> List[ScoredPoint]:
        hits: List[ScoredPoint] = []
        for rec in self.iter_records():
            if rec.embedding is None:
                continue
            s = cosine_similarity(query, rec.embedding)
            if s >= threshold:
                hits.append(ScoredPoint(id=rec.id, score=s, payload=rec.metadata))
        hits.sort(key=lambda h: -h.score)
        return hits[:limit]

    def text_search(self, query: str, limit: int) -> List[ScoredPoint]:
        """Substring scan: title weight 0.3, content weight 0.7 (storage.rs:341-388)."""
        q = query.lower()
        hits: List[ScoredPoint] = []
        if not q:
            return hits
        for rec in self.iter_records():
            score = 0.0
            if q in (rec.title or "").lower():
                score += 0.3
            if q in (rec.content or "").lower():
                score += 0.7
            if score > 0.0:
                hits.append(ScoredPoint(id=rec.id, score=score, payload=rec.metadata))
        hits.sort(key=lambda h: -h.score)
        return hits[:limit]

    def hybrid_search(self, query_vector: Sequence[float], query_text: str,
                      limit: int, alpha: float = 0.7) -> List[ScoredPoint]:
        """Alpha-blend of vector + text scores (storage.rs:390-435)."""
        dense = {h.id: h.score for h in self.vector_search(query_vector, limit * 4)}
        text = {h.id: h.score for h in self.text_search(query_text, limit * 4)}
        merged: Dict[str, float] = {}
        for id_ in set(dense) | set(text):
            merged[id_] = alpha * dense.get(id_, 0.0) + (1 - alpha) * text.get(id_, 0.0)
        out = [ScoredPoint(id=i, score=s) for i, s in merged.items()]
        out.sort(key=lambda h: -h.score)
        return out[:limit]

    def metadata_search(self, predicate: Callable[[Dict[str, Any]], bool],
                        limit: int) -> List[DocumentRecord]:
        """Full-scan metadata filter (storage.rs:809-847)."""
        out = []
        for rec in self.iter_records():
            if predicate(rec.metadata):
                out.append(rec)
                if len(out) >= limit:
                    break
        return out

    # -- durability ---------------------------------------------------------------
    def flush(self) -> None:
        """Persist pending writes. No-op for memory store."""

    def close(self) -> None:
        self.flush()

    def create_backup(self, backup_path: str) -> Dict[str, Any]:
        raise NotImplementedError

    def restore_backup(self, backup_path: str) -> Dict[str, Any]:
        raise NotImplementedError

    def get_stats(self) -> StorageStats:
        raise NotImplementedError

    def health_check(self) -> bool:
        return True


class MemoryDocumentStore(DocumentStore):
    """Dict-backed store — the tempdir-free test fixture and cache tier."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._docs: Dict[str, DocumentRecord] = {}
        self._kv: Dict[str, bytes] = {}

    def batch_insert(self, records: Sequence[DocumentRecord]) -> None:
        with self._lock:
            for r in records:
                self._docs[r.id] = r

    def get(self, id_: str) -> Optional[DocumentRecord]:
        return self._docs.get(id_)

    def batch_delete(self, ids: Sequence[str]) -> int:
        with self._lock:
            n = 0
            for i in ids:
                if self._docs.pop(i, None) is not None:
                    n += 1
            return n

    def count(self) -> int:
        return len(self._docs)

    def iter_ids(self) -> Iterable[str]:
        return list(self._docs.keys())

    def clear(self) -> None:
        with self._lock:
            self._docs.clear()
            self._kv.clear()

    def put_kv(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = bytes(value)

    def get_kv(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def delete_kv(self, key: str) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None

    def iter_kv_prefix(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        with self._lock:
            return [(k, v) for k, v in self._kv.items() if k.startswith(prefix)]

    def get_stats(self) -> StorageStats:
        approx = sum(
            len(r.content)
            + 8 * (len(r.embedding) if r.embedding is not None else 0)
            for r in self._docs.values()
        )
        return StorageStats(document_count=len(self._docs), estimated_size_bytes=approx)

    def create_backup(self, backup_path: str) -> Dict[str, Any]:
        """Same checksummed single-file format as FileDocumentStore, so memory
        and file deployments can restore each other's backups."""
        from grape_vector_db_tpu_torch.storage import file as file_store

        with self._lock:
            blob = file_store.encode_store_payload(self._docs.values(), self._kv)
            count = len(self._docs)
        return file_store.write_backup_file(blob, backup_path, count)

    def restore_backup(self, backup_path: str) -> Dict[str, Any]:
        from grape_vector_db_tpu_torch.storage import file as file_store

        header, blob = file_store.read_backup_file(backup_path)
        docs, kv = file_store.decode_store_payload(blob)
        with self._lock:
            self._docs = docs
            self._kv = kv
        return {"restored": header.get("count", len(self._docs))}

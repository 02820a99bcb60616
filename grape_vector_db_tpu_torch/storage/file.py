"""FileDocumentStore — durable WAL + snapshot store with checksummed backups.

PyTorch port's counterpart of ``grape_vector_db_tpu/storage/file.py``, in
the same file formats. Rebuilds the reference's sled persistence semantics
without sled:
- write path: append-only WAL (msgpack frames) + periodic snapshot compaction
  (sled's LSM tree becomes WAL+snapshot; flush interval semantics of
  advanced_storage.rs:36-47).
- backup/restore: single-file, SHA-256-checksummed, written via tmp + atomic
  rename, with a pre-restore auto-backup (storage.rs:500-712 BackupData flow).
- generic KV namespace used by Raft state persistence
  (advanced_storage.rs:627-651).

Embeddings are serialized as raw little-endian f32 bytes (half the size of
msgpack float lists, zero-copy numpy decode).

MessagePack comes from the port's own codec (``storage/msgpack_codec.py``),
byte for byte msgpack's. Snapshots, backups and index snapshots are
compressed with zstandard where it imports, in the JAX package's format, so
either package opens the other's files. Without zstandard they are
compressed with stdlib zlib at the same level, in 8 MiB pieces on a thread
each, marked by their own 8-byte magic ``GVDBZLB1``; the readers take both, and a file that needs zstandard
raises ``StorageError`` where it is missing. The JAX package cannot read a
zlib file.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from grape_vector_db_tpu_torch.errors import BackupError, SerializationError, StorageError
from grape_vector_db_tpu_torch.storage.msgpack_codec import packb, unpackb
from grape_vector_db_tpu_torch.storage.store import DocumentStore, StorageStats
from grape_vector_db_tpu_torch.types import DocumentRecord, now_ms

__all__ = ["FileDocumentStore", "compress", "decompress"]

_MAGIC = b"GVDBTPU1"          # a store payload: this, then a zstd frame
_ZLIB_MAGIC = b"GVDBZLB1"     # any zlib-compressed blob: this, then framed zlib streams
_ZLIB_CHUNK = 8 << 20         # input bytes a zlib stream takes
_ZSTD_FRAME = b"\x28\xb5\x2f\xfd"
_FRAME_HDR = struct.Struct("<I")


def _zstandard():
    """The zstandard module, or None where it does not import."""
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def _on_threads(fn, items) -> list:
    """``[fn(x) for x in items]``, on a thread each up to the CPU count."""
    if len(items) < 2:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def compress(raw: bytes, level: int = 3) -> bytes:
    """A zstd frame where zstandard imports. Otherwise ``_ZLIB_MAGIC``, then
    the input cut into ``_ZLIB_CHUNK`` pieces, each a little-endian u32
    length and a zlib stream at the same level, compressed on a thread each
    (zlib releases the GIL): one zlib stream at level 3 runs at ~14 MB/s
    on embedding bytes, which would stall every snapshot of a large store.
    ``decompress`` takes the pieces on threads too."""
    zstd = _zstandard()
    if zstd is not None:
        return zstd.ZstdCompressor(level=level).compress(raw)
    view = memoryview(raw)
    pieces = [view[i:i + _ZLIB_CHUNK] for i in range(0, len(raw), _ZLIB_CHUNK)]
    streams = _on_threads(lambda p: zlib.compress(p, level), pieces)
    return _ZLIB_MAGIC + b"".join(_FRAME_HDR.pack(len(z)) + z for z in streams)


def decompress(blob: bytes) -> bytes:
    """Inverse of ``compress`` for either route."""
    if blob[:8] == _ZLIB_MAGIC:
        view, streams, pos = memoryview(blob), [], 8
        while pos < len(blob):
            (n,) = _FRAME_HDR.unpack_from(blob, pos)
            pos += _FRAME_HDR.size
            if pos + n > len(blob):
                raise SerializationError("truncated zlib blob")
            streams.append(view[pos:pos + n])
            pos += n
        return b"".join(_on_threads(zlib.decompress, streams))
    if blob[:4] == _ZSTD_FRAME:
        zstd = _zstandard()
        if zstd is None:
            raise StorageError("this file is zstd-compressed and zstandard does not "
                               "import here")
        return zstd.ZstdDecompressor().decompress(blob)
    raise SerializationError("neither a zstd frame nor a zlib blob")


def _enc_record(rec: DocumentRecord) -> Dict[str, Any]:
    d = rec.to_dict()
    emb = d.pop("embedding", None)
    if emb is not None:
        d["embedding_f32"] = np.asarray(emb, dtype=np.float32).tobytes()
    return d


def _dec_record(d: Dict[str, Any]) -> DocumentRecord:
    """The record, its embedding an f32 ndarray as the ingest path leaves it
    (the JAX package makes a list of floats: 768 float objects a record, most
    of a large store's decode and, as ``np.asarray`` of them, of its index
    rebuild)."""
    d = dict(d)
    raw = d.pop("embedding_f32", None)
    if raw is not None:
        d["embedding"] = np.frombuffer(raw, dtype=np.float32).copy()
    return DocumentRecord.from_dict(d)


def write_backup_file(blob: bytes, backup_path: str, count: int) -> Dict[str, Any]:
    """Checksummed single-file backup, written atomically (storage.rs:500-576)."""
    checksum = hashlib.sha256(blob).hexdigest()
    header = packb(
        {"version": 1, "created_at": now_ms(), "count": count, "checksum": checksum})
    tmp = backup_path + ".tmp"
    os.makedirs(os.path.dirname(backup_path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_FRAME_HDR.pack(len(header)))
        f.write(header)
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, backup_path)
    return {"path": backup_path, "checksum": checksum, "count": count}


def read_backup_file(backup_path: str) -> Tuple[Dict[str, Any], bytes]:
    """Read + checksum-verify a backup file; returns (header, blob)."""
    if not os.path.exists(backup_path):
        raise BackupError(f"backup not found: {backup_path}")
    with open(backup_path, "rb") as f:
        data = f.read()
    (hlen,) = _FRAME_HDR.unpack_from(data, 0)
    header = unpackb(data[_FRAME_HDR.size:_FRAME_HDR.size + hlen])
    blob = data[_FRAME_HDR.size + hlen:]
    if hashlib.sha256(blob).hexdigest() != header.get("checksum"):
        raise BackupError("backup checksum mismatch — refusing to restore")
    return header, blob


def encode_store_payload(docs, kv, level: int = 3) -> bytes:
    """Shared snapshot/backup payload format — all backends must produce and
    consume the same bytes so their backups stay interchangeable:
    ``_MAGIC`` and a zstd frame (the JAX package's format), or, without
    zstandard, the zlib blob under its own magic."""
    payload = {
        "docs": [_enc_record(r) for r in docs],
        "kv": dict(kv),
        "created_at": now_ms(),
    }
    blob = compress(packb(payload), level)
    return _MAGIC + blob if blob[:4] == _ZSTD_FRAME else blob


def decode_store_payload(blob: bytes):
    """Returns (docs dict, kv dict) from an encode_store_payload blob of
    either route."""
    if blob[:8] == _MAGIC:
        blob = blob[8:]                     # a zstd frame
    elif blob[:8] != _ZLIB_MAGIC:
        raise SerializationError("bad snapshot magic")
    payload = unpackb(decompress(blob))
    docs = {d["id"]: _dec_record(d) for d in payload["docs"]}
    return docs, dict(payload["kv"])


class FileDocumentStore(DocumentStore):
    """In-memory map + durable WAL/snapshot on disk."""

    def __init__(
        self,
        data_dir: str,
        compact_wal_bytes: int = 64 * 1024 * 1024,
        sync_writes: bool = False,
        compression_level: int = 3,
        flush_interval_ms: int = 1000,
    ):
        self.data_dir = data_dir
        self.compact_wal_bytes = compact_wal_bytes
        self.sync_writes = sync_writes
        self.compression_level = compression_level
        self._lock = threading.RLock()
        self._docs: Dict[str, DocumentRecord] = {}
        self._kv: Dict[str, bytes] = {}
        self._last_backup: Optional[int] = None
        self._last_flush: Optional[int] = None
        os.makedirs(data_dir, exist_ok=True)
        self._snapshot_path = os.path.join(data_dir, "snapshot.gvdb")
        self._wal_path = os.path.join(data_dir, "wal.gvdb")
        self._load()
        self._wal = open(self._wal_path, "ab")
        # Background flusher (the reference's sled 1s flush interval,
        # advanced_storage.rs:36-47). sync_writes=True fsyncs inline instead.
        self._stop_flusher = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if flush_interval_ms > 0 and not sync_writes:
            def _flush_loop() -> None:
                while not self._stop_flusher.wait(flush_interval_ms / 1e3):
                    try:
                        self.flush()
                    except ValueError:
                        return  # file closed underneath us
                    except OSError:
                        continue  # transient I/O error: keep trying
            self._flusher = threading.Thread(target=_flush_loop, daemon=True,
                                             name="gvdb-flusher")
            self._flusher.start()

    # -- load / replay -----------------------------------------------------------

    def _load(self) -> None:
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path, "rb") as f:
                blob = f.read()
            self._apply_snapshot_blob(blob)
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                data = f.read()
            pos = 0
            while pos + _FRAME_HDR.size <= len(data):
                (ln,) = _FRAME_HDR.unpack_from(data, pos)
                start = pos + _FRAME_HDR.size
                if start + ln > len(data):
                    break  # torn tail write — ignore (crash recovery)
                try:
                    op = unpackb(data[start:start + ln])
                except Exception:
                    break
                self._apply_op(op)
                pos = start + ln
            if pos < len(data):
                # Truncate the torn tail: appending after unparseable bytes
                # would make every later write unreadable on the next replay.
                with open(self._wal_path, "r+b") as f:
                    f.truncate(pos)

    def _apply_snapshot_blob(self, blob: bytes) -> None:
        self._docs, self._kv = decode_store_payload(blob)

    def _apply_op(self, op: List[Any]) -> None:
        kind = op[0]
        if kind == "ins":
            for d in op[1]:
                rec = _dec_record(d)
                self._docs[rec.id] = rec
        elif kind == "del":
            for i in op[1]:
                self._docs.pop(i, None)
        elif kind == "kv":
            self._kv[op[1]] = op[2]
        elif kind == "kvdel":
            self._kv.pop(op[1], None)
        elif kind == "clear":
            self._docs.clear()
            self._kv.clear()

    # -- WAL write -----------------------------------------------------------------

    def _append(self, op: List[Any]) -> None:
        buf = packb(op)
        self._wal.write(_FRAME_HDR.pack(len(buf)))
        self._wal.write(buf)
        if self.sync_writes:
            self._wal.flush()
            os.fsync(self._wal.fileno())
        if self._wal.tell() > self.compact_wal_bytes:
            self._compact_locked()

    # -- CRUD -----------------------------------------------------------------------

    def batch_insert(self, records: Sequence[DocumentRecord]) -> None:
        with self._lock:
            for r in records:
                self._docs[r.id] = r
            self._append(["ins", [_enc_record(r) for r in records]])

    def get(self, id_: str) -> Optional[DocumentRecord]:
        return self._docs.get(id_)

    def batch_delete(self, ids: Sequence[str]) -> int:
        with self._lock:
            hit = [i for i in ids if i in self._docs]
            for i in hit:
                del self._docs[i]
            if hit:
                self._append(["del", hit])
            return len(hit)

    def count(self) -> int:
        return len(self._docs)

    def iter_ids(self) -> Iterable[str]:
        return list(self._docs.keys())

    def clear(self) -> None:
        with self._lock:
            self._docs.clear()
            self._kv.clear()
            self._append(["clear"])

    # -- KV ---------------------------------------------------------------------------

    def put_kv(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = bytes(value)
            self._append(["kv", key, bytes(value)])

    def get_kv(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def delete_kv(self, key: str) -> bool:
        with self._lock:
            existed = self._kv.pop(key, None) is not None
            if existed:
                self._append(["kvdel", key])
            return existed

    def iter_kv_prefix(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        with self._lock:
            return [(k, v) for k, v in self._kv.items() if k.startswith(prefix)]

    # -- durability ----------------------------------------------------------------------

    def _snapshot_blob(self) -> bytes:
        return encode_store_payload(self._docs.values(), self._kv, self.compression_level)

    def _compact_locked(self) -> None:
        blob = self._snapshot_blob()
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        self._wal.close()
        self._wal = open(self._wal_path, "wb")  # truncate

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def flush(self) -> None:
        with self._lock:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._last_flush = now_ms()

    def close(self) -> None:
        self._stop_flusher.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        with self._lock:
            if not self._wal.closed:
                self._compact_locked()
                self._wal.flush()
                self._wal.close()

    # -- backup / restore -------------------------------------------------------------------

    def create_backup(self, backup_path: str) -> Dict[str, Any]:
        """Single-file checksummed backup written atomically (storage.rs:500-576)."""
        with self._lock:
            blob = self._snapshot_blob()
            count = len(self._docs)
        info = write_backup_file(blob, backup_path, count)
        self._last_backup = now_ms()
        return info

    def restore_backup(self, backup_path: str) -> Dict[str, Any]:
        """Checksum-verified restore with pre-restore auto-backup (storage.rs:578-712)."""
        header, blob = read_backup_file(backup_path)
        pre = backup_path + f".pre-restore-{int(time.time())}"
        self.create_backup(pre)
        with self._lock:
            self._apply_snapshot_blob(blob)
            self._compact_locked()
        return {"restored": header.get("count", len(self._docs)), "pre_restore_backup": pre}

    # -- stats --------------------------------------------------------------------------------

    def get_stats(self) -> StorageStats:
        raw = sum(
            len(r.content or "")
            + 4 * (len(r.embedding) if r.embedding is not None else 0)
            + len(str(r.metadata))
            for r in self._docs.values()
        )
        disk = 0
        for p in (self._snapshot_path, self._wal_path):
            if os.path.exists(p):
                disk += os.path.getsize(p)
        return StorageStats(
            document_count=len(self._docs),
            estimated_size_bytes=disk,
            compression_ratio=(disk / raw) if raw else 1.0,
            last_backup_time=self._last_backup,
            last_flush_time=self._last_flush,
        )

    def health_check(self) -> bool:
        try:
            return not self._wal.closed and os.path.isdir(self.data_dir)
        except Exception:
            return False

"""Native storage engine binding — C++ segment-log KV behind the DocumentStore
trait.

PyTorch port's counterpart of ``grape_vector_db_tpu/storage/native.py``, over
the same ``native/gvdb_store.cpp`` and the same record encoding, with the
port's msgpack codec (``storage/msgpack_codec.py``).

The reference's entire storage layer is native (sled, a Rust embedded KV);
this is the TPU framework's native equivalent: ``native/gvdb_store.cpp``
(append-only checksummed segment log + in-memory hash index, crash-safe torn-
tail truncation, compaction) exposed over a C ABI and bound with ctypes
(pybind11 is not in this image).

``NativeDocumentStore`` stores msgpack-encoded DocumentRecords (embeddings as
raw f32 bytes) under ``d:{id}`` keys and generic KV under ``k:{key}`` — the
same two namespaces the Python FileDocumentStore keeps, so the two backends
are interchangeable behind VectorDatabase.

The shared library is built on demand with g++ into the port's own
``grape_vector_db_tpu_torch/_build/`` (rebuilt when the source is newer),
so the two packages never write one library file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from grape_vector_db_tpu_torch.errors import StorageError
from grape_vector_db_tpu_torch.storage.file import (
    _dec_record,
    _enc_record,
    decode_store_payload,
    encode_store_payload,
    read_backup_file,
    write_backup_file,
)
from grape_vector_db_tpu_torch.storage.msgpack_codec import packb, unpackb
from grape_vector_db_tpu_torch.storage.store import DocumentStore, StorageStats
from grape_vector_db_tpu_torch.types import DocumentRecord, now_ms

__all__ = ["NativeKV", "NativeDocumentStore", "native_available"]

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "_build")


def _build_lib() -> str:
    so = os.path.abspath(os.path.join(_BUILD_DIR, "libgvdb_store.so"))
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "gvdb_store.cpp"))
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # through a temporary name: a process that loads the library never
    # finds it half written
    tmp = f"{so}.tmp.{os.getpid()}"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-o", tmp, src],
        check=True, capture_output=True,
    )
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_lib())
            lib.gvdb_open.restype = ctypes.c_void_p
            lib.gvdb_open.argtypes = [ctypes.c_char_p]
            lib.gvdb_put.restype = ctypes.c_int
            lib.gvdb_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint32, ctypes.c_char_p,
                                     ctypes.c_uint32]
            lib.gvdb_get_len.restype = ctypes.c_int64
            lib.gvdb_get_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint32]
            lib.gvdb_get.restype = ctypes.c_int64
            lib.gvdb_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint32, ctypes.c_char_p,
                                     ctypes.c_uint32]
            lib.gvdb_delete.restype = ctypes.c_int
            lib.gvdb_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint32]
            lib.gvdb_count.restype = ctypes.c_uint64
            lib.gvdb_count.argtypes = [ctypes.c_void_p]
            lib.gvdb_dead_bytes.restype = ctypes.c_uint64
            lib.gvdb_dead_bytes.argtypes = [ctypes.c_void_p]
            lib.gvdb_flush.restype = ctypes.c_int
            lib.gvdb_flush.argtypes = [ctypes.c_void_p]
            lib.gvdb_keys.restype = ctypes.c_int64
            lib.gvdb_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
            lib.gvdb_compact.restype = ctypes.c_int
            lib.gvdb_compact.argtypes = [ctypes.c_void_p]
            lib.gvdb_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def native_available() -> bool:
    try:
        _lib()
        return True
    except Exception:
        return False


class NativeKV:
    """Thin pythonic wrapper over the C KV handle.

    A host-side lock covers multi-call sequences (get_len + get): the C mutex
    is per-call, so an interleaved re-put that grows a value would otherwise
    make the reader's sized buffer too small."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = _lib()
        self._h = self._lib.gvdb_open(path.encode())
        if not self._h:
            raise StorageError(f"gvdb_open failed for {path}")
        self.path = path
        self._lock = threading.RLock()

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if self._lib.gvdb_put(self._h, key, len(key), value, len(value)) != 0:
                raise StorageError("gvdb_put failed")

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            n = self._lib.gvdb_get_len(self._h, key, len(key))
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(int(n))
            got = self._lib.gvdb_get(self._h, key, len(key), buf, int(n))
            if got < 0:
                raise StorageError(f"gvdb_get failed ({got})")
            return buf.raw[:got]

    def delete(self, key: bytes) -> bool:
        return self._lib.gvdb_delete(self._h, key, len(key)) == 0

    def count(self) -> int:
        return int(self._lib.gvdb_count(self._h))

    def keys(self) -> List[bytes]:
        import struct

        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            with self._lock:
                n = self._lib.gvdb_keys(self._h, buf, cap)
            if n >= 0:
                raw = buf.raw[:n]
                out: List[bytes] = []
                pos = 0
                while pos + 4 <= len(raw):
                    (ln,) = struct.unpack_from("<I", raw, pos)
                    out.append(raw[pos + 4:pos + 4 + ln])
                    pos += 4 + ln
                return out
            cap = -int(n) + 1024

    def flush(self) -> None:
        self._lib.gvdb_flush(self._h)

    def compact(self) -> None:
        if self._lib.gvdb_compact(self._h) != 0:
            raise StorageError("gvdb_compact failed")

    @property
    def dead_bytes(self) -> int:
        return int(self._lib.gvdb_dead_bytes(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.gvdb_close(self._h)
            self._h = None


class NativeDocumentStore(DocumentStore):
    """DocumentStore over the native KV engine."""

    def __init__(self, data_dir: str, compact_dead_bytes: int = 64 * 1024 * 1024):
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.kv = NativeKV(os.path.join(data_dir, "store.gvdbn"))
        self.compact_dead_bytes = compact_dead_bytes
        self._last_backup: Optional[int] = None

    # -- CRUD -------------------------------------------------------------------

    def batch_insert(self, records: Sequence[DocumentRecord]) -> None:
        for r in records:
            self.kv.put(b"d:" + r.id.encode(),
                        packb(_enc_record(r)))
        self._maybe_compact()

    def get(self, id_: str) -> Optional[DocumentRecord]:
        raw = self.kv.get(b"d:" + id_.encode())
        if raw is None:
            return None
        return _dec_record(unpackb(raw))

    def batch_delete(self, ids: Sequence[str]) -> int:
        n = 0
        for i in ids:
            if self.kv.delete(b"d:" + i.encode()):
                n += 1
        return n

    def count(self) -> int:
        return sum(1 for k in self.kv.keys() if k.startswith(b"d:"))

    def iter_ids(self) -> Iterable[str]:
        return [k[2:].decode() for k in self.kv.keys() if k.startswith(b"d:")]

    def clear(self) -> None:
        for k in self.kv.keys():
            self.kv.delete(k)
        self.kv.compact()

    # -- KV namespace ---------------------------------------------------------------

    def put_kv(self, key: str, value: bytes) -> None:
        self.kv.put(b"k:" + key.encode(), bytes(value))

    def get_kv(self, key: str) -> Optional[bytes]:
        return self.kv.get(b"k:" + key.encode())

    def delete_kv(self, key: str) -> bool:
        return self.kv.delete(b"k:" + key.encode())

    def iter_kv_prefix(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        p = b"k:" + prefix.encode()
        out = []
        for k in self.kv.keys():
            if k.startswith(p):
                out.append((k[2:].decode(), self.kv.get(k) or b""))
        return out

    # -- durability -------------------------------------------------------------------

    def _maybe_compact(self) -> None:
        if self.kv.dead_bytes > self.compact_dead_bytes:
            self.kv.compact()

    def flush(self) -> None:
        self.kv.flush()

    def close(self) -> None:
        self.kv.close()

    def create_backup(self, backup_path: str) -> Dict[str, Any]:
        blob = encode_store_payload(
            list(self.iter_records()), dict(self.iter_kv_prefix(""))
        )
        info = write_backup_file(blob, backup_path, self.count())
        self._last_backup = now_ms()
        return info

    def restore_backup(self, backup_path: str) -> Dict[str, Any]:
        header, blob = read_backup_file(backup_path)
        docs, kv = decode_store_payload(blob)
        self.clear()
        self.batch_insert(list(docs.values()))
        for k, v in kv.items():
            self.put_kv(k, v)
        return {"restored": header.get("count", self.count())}

    def get_stats(self) -> StorageStats:
        size = os.path.getsize(self.kv.path) if os.path.exists(self.kv.path) else 0
        return StorageStats(
            document_count=self.count(),
            estimated_size_bytes=size,
            last_backup_time=self._last_backup,
            extra={"dead_bytes": self.kv.dead_bytes, "engine": "native"},
        )

    def health_check(self) -> bool:
        return self.kv._h is not None

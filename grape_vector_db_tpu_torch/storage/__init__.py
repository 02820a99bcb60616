"""Host-side storage layer.

Replaces the reference's sled-backed stores (storage.rs BasicVectorStore,
advanced_storage.rs AdvancedStorage): payloads/documents live host-side in a
WAL + snapshot store; dense vectors live on device (index layer) with the store
as the durable source of truth for rebuilds.

The file store (``storage/file.py``) and the native segment-log store
(``storage/native.py``) write the JAX package's formats through the port's
own msgpack codec (``storage/msgpack_codec.py``).
"""

from grape_vector_db_tpu_torch.storage.store import DocumentStore, MemoryDocumentStore, StorageStats
from grape_vector_db_tpu_torch.storage.file import FileDocumentStore

__all__ = ["DocumentStore", "MemoryDocumentStore", "FileDocumentStore", "StorageStats"]

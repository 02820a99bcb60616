"""Host-side storage layer.

Replaces the reference's sled-backed stores (storage.rs BasicVectorStore,
advanced_storage.rs AdvancedStorage): payloads/documents live host-side;
dense vectors live on device (index layer) with the store as the source of
truth for rebuilds.

Only the memory store is ported. ``FileDocumentStore`` (storage/file.py)
needs msgpack and zstandard and is still to be ported (ROADMAP), so this
package does not import it.
"""

from grape_vector_db_tpu_torch.storage.store import DocumentStore, MemoryDocumentStore, StorageStats

__all__ = ["DocumentStore", "MemoryDocumentStore", "StorageStats"]

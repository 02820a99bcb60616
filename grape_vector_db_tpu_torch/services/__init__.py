"""Cross-cutting runtime services (reference L1): embeddings, metrics,
resilience, concurrency/batching executor, enterprise auth."""

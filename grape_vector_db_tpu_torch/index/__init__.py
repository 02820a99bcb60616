"""Index layer: the VectorIndex interface and its device implementations.

Ported so far: ``FlatDeviceIndex`` (exact device scan). The other index
kinds of the JAX package are still to be ported (ROADMAP).
"""

from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex, FlatIndex

__all__ = ["VectorIndex", "IndexStats", "SearchHit", "FlatDeviceIndex", "FlatIndex"]

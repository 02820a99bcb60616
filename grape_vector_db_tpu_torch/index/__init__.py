"""Index layer: the VectorIndex interface and its device implementations.

Ported so far: ``FlatDeviceIndex`` (exact device scan) and the IVF family
(``IvfDeviceIndex``, ``Int8IvfDeviceIndex``, ``Int4IvfDeviceIndex``). The
other index kinds of the JAX package are still to be ported (ROADMAP).
"""

from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex, FlatIndex
from grape_vector_db_tpu_torch.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int4 import Int4IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int8 import Int8IvfDeviceIndex

__all__ = ["VectorIndex", "IndexStats", "SearchHit", "FlatDeviceIndex", "FlatIndex",
           "IvfDeviceIndex", "Int8IvfDeviceIndex", "Int4IvfDeviceIndex"]

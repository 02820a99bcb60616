"""Index layer: the VectorIndex interface and its device implementations.

Ported so far: ``FlatDeviceIndex`` (exact device scan), the two-stage flat
kinds (``BinaryDeviceIndex``, ``Int8DeviceIndex``, ``PqDeviceIndex``), the
IVF family (``IvfDeviceIndex``, ``Int8IvfDeviceIndex``,
``Int4IvfDeviceIndex``), ``IvfPqDeviceIndex``, the projected IVF kinds
(``ProjectedInt8IvfIndex``, ``ProjectedInt4IvfIndex``) and the graph index
(``GraphDeviceIndex``). The mesh-sharded kinds live in
``grape_vector_db_tpu_torch.parallel``.
"""

from grape_vector_db_tpu_torch.index.base import IndexStats, SearchHit, VectorIndex
from grape_vector_db_tpu_torch.index.binary import BinaryDeviceIndex
from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex, FlatIndex
from grape_vector_db_tpu_torch.index.graph import GraphDeviceIndex
from grape_vector_db_tpu_torch.index.int8 import Int8DeviceIndex
from grape_vector_db_tpu_torch.index.ivf import IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int4 import Int4IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_int8 import Int8IvfDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_pq import IvfPqDeviceIndex
from grape_vector_db_tpu_torch.index.ivf_proj import ProjectedInt4IvfIndex, ProjectedInt8IvfIndex
from grape_vector_db_tpu_torch.index.pq import PqDeviceIndex

__all__ = ["VectorIndex", "IndexStats", "SearchHit", "FlatDeviceIndex", "FlatIndex",
           "BinaryDeviceIndex", "Int8DeviceIndex", "PqDeviceIndex",
           "IvfDeviceIndex", "Int8IvfDeviceIndex", "Int4IvfDeviceIndex", "IvfPqDeviceIndex",
           "ProjectedInt8IvfIndex", "ProjectedInt4IvfIndex", "GraphDeviceIndex"]

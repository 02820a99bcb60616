"""Mesh-parallel corpus sharding (the data plane of cluster mode), in one
process.

PyTorch counterpart of ``grape_vector_db_tpu/parallel``: the corpus splits
over the ``shard`` axis of a ``Mesh`` of ``torch.device``s, every shard
computes its local top-k on its own device, and one merge on the mesh's
first device takes the global top-k (``parallel/mesh.py``).
"""

from grape_vector_db_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedFlatIndex,
    ShardedInt4IvfIndex,
    ShardedInt8IvfIndex,
    ShardedIvfIndex,
    ShardedTensor,
    local_devices,
    make_mesh,
    make_mesh_2d,
    replicated_sharded_topk,
    sharded_ivf_topk,
    sharded_scored_topk,
)

__all__ = ["ShardedFlatIndex", "ShardedIvfIndex", "ShardedInt8IvfIndex",
           "ShardedInt4IvfIndex", "make_mesh", "make_mesh_2d",
           "replicated_sharded_topk", "sharded_ivf_topk", "sharded_scored_topk",
           "Mesh", "ShardedTensor", "local_devices"]

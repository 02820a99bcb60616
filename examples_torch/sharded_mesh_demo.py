"""Serving over a mesh of devices through the product API on the PyTorch +
CUDA port: a VectorDatabase whose index is sharded over the entries of a
mesh that this one process drives (``grape_vector_db_tpu_torch.parallel``:
each shard's top-k runs on its device, one merge on the first).

The mesh is built from ``parallel.mesh.local_devices(device)``: every CUDA
device of the host for ``--device cuda``, the CPU for ``--device cpu``.
Where a mesh asks for more shards than there are devices, the devices repeat
in turn, so parts 1 and 2 set ``device.n_shards = 4`` and run 4 shards on a
single card as well as on four.

Shows:
- kind="sharded_ivf_int8" through the ordinary VectorDatabase facade
- the 2D replica x shard layout via device.n_replicas
- device.auto_shard (what ClusterNode enables: any >1-device host serves a
  mesh index automatically)
- the capacity tier kind="ivf_int8_proj" (a PCA projection + int8 lists)

Run: python examples_torch/sharded_mesh_demo.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from grape_vector_db_tpu_torch import Document, SearchRequest, VectorDatabase, VectorDbConfig
from grape_vector_db_tpu_torch.parallel.mesh import local_devices


def make_docs(rng, n, dim):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return [
        Document(id=f"doc-{i}", content=f"document {i}", vector=vecs[i])
        for i in range(n)
    ], vecs


def main(device: str = "cuda") -> dict:
    rng = np.random.default_rng(0)
    print(f"devices: {len(local_devices(device))} x {torch.device(device).type}")
    out = {}

    # 1) explicit sharded kind: corpus rows sharded across the mesh, each
    #    shard searched on its device, one merge of the shards' top-k
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.index.kind = "sharded_ivf_int8"
    cfg.index.nlist = 16
    cfg.index.nprobe = 8
    cfg.device.storage_dtype = "float32"
    cfg.device.n_shards = 4
    db = VectorDatabase(config=cfg, device=device)
    docs, vecs = make_docs(rng, 400, 128)
    db.batch_add_documents(docs)
    hits = db.search(SearchRequest(vector=vecs[7].tolist(), limit=3))
    print("sharded_ivf_int8:", db.stats().index_kind,
          "->", [h.document.id for h in hits])
    out["sharded_ivf_int8"] = [h.document.id for h in hits]
    db.close()

    # 2) 2D replica x shard mesh: the query batch splits over 2 replica
    #    lanes, the corpus shards over 4 mesh entries within each lane
    cfg2 = VectorDbConfig(vector_dimension=128)
    cfg2.index.kind = "sharded_flat"
    cfg2.device.n_replicas = 2
    cfg2.device.n_shards = 4
    cfg2.device.storage_dtype = "float32"
    db2 = VectorDatabase(config=cfg2, device=device)
    db2.batch_add_documents(docs)
    hits = db2.search(SearchRequest(vector=vecs[11].tolist(), limit=3))
    print(f"sharded_flat 2D (replicas={db2.index.n_replicas} x "
          f"shards={db2.index.n_shards}):",
          "->", [h.document.id for h in hits])
    out["sharded_flat_2d"] = [h.document.id for h in hits]
    db2.close()

    # 3) auto_shard: what ClusterNode turns on: plain kinds upgrade to
    #    their sharded twins whenever the host has >1 device. On a host of
    #    one device (one card, or the CPU) the kind stays "flat".
    cfg3 = VectorDbConfig(vector_dimension=128)
    cfg3.index.kind = "flat"
    cfg3.device.auto_shard = True
    cfg3.device.storage_dtype = "float32"
    db3 = VectorDatabase(config=cfg3, device=device)
    db3.batch_add_documents(docs[:100])
    print("auto_shard upgraded 'flat' ->", db3.stats().index_kind)
    out["auto_shard"] = db3.stats().index_kind
    db3.close()

    # 4) capacity tier: PCA-projected int8 (below int8's bytes a row
    #    without PQ's table lookups)
    cfg4 = VectorDbConfig(vector_dimension=256)
    cfg4.index.kind = "ivf_int8_proj"
    cfg4.index.proj_dim = 128
    cfg4.index.nlist = 16
    cfg4.index.nprobe = 8
    cfg4.device.storage_dtype = "float32"
    db4 = VectorDatabase(config=cfg4, device=device)
    spec = (1.0 + np.arange(256)) ** -0.5
    docs4, vecs4 = make_docs(rng, 400, 256)
    for d, v in zip(docs4, vecs4):
        d.vector = (v * spec).astype(np.float32)
    db4.batch_add_documents(docs4)
    hits = db4.search(SearchRequest(vector=docs4[5].vector.tolist(), limit=3))
    print("ivf_int8_proj (768->384-style projection at 256->128):",
          "->", [h.document.id for h in hits])
    out["ivf_int8_proj"] = [h.document.id for h in hits]
    db4.close()
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

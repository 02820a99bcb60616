"""Single-node gRPC quick start on the PyTorch + CUDA port (reference
examples/single_node_simple.rs): start the server in-process, connect the
typed client, do vector + document round trips, read stats, shut down.

Run: python examples_torch/single_node_simple.py [--device cuda|cpu]
"""

import argparse
import tempfile

import numpy as np

from grape_vector_db_tpu_torch import VectorDatabase, VectorDbConfig
from grape_vector_db_tpu_torch.server.grpc_server import VectorDbClient, build_grpc_server
from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb


def main(data_dir: str | None = None, device: str = "cuda") -> dict:
    data_dir = data_dir or tempfile.mkdtemp(prefix="gvdb_single_")
    cfg = VectorDbConfig(vector_dimension=64)
    cfg.index.initial_capacity = 1024
    db = VectorDatabase(path=data_dir, config=cfg, device=device)
    server, port, _ = build_grpc_server(db, port=0)
    server.start()
    print(f"serving on :{port}")
    client = VectorDbClient(f"127.0.0.1:{port}")
    try:
        rng = np.random.default_rng(0)
        pts = [
            pb.Point(id=f"v{i}",
                     vector=pb.Vector(values=rng.standard_normal(64).astype(float)),
                     payload={"lang": "en" if i % 2 == 0 else "de"})
            for i in range(50)
        ]
        print("upserted:", client.upsert_points(pts).upserted)

        q = list(pts[7].vector.values)
        hits = client.search(q, limit=3)
        print("top-3:", [(r.id, round(r.score, 3)) for r in hits.results])
        assert hits.results[0].id == "v7"

        filtered = client.search(q, limit=3, filter_sql="lang = 'en'")
        print("filtered:", [r.id for r in filtered.results])

        client.call("AddDocument", pb.AddDocumentRequest(documents=[
            pb.Document(id="doc-1", title="Hello", content="hello vector world"),
        ]))
        got = client.call("GetDocument", pb.GetDocumentRequest(id="doc-1"))
        assert got.found and got.document.title == "Hello"

        stats = client.call("GetStats", pb.GetStatsRequest())
        print(f"stats: {stats.document_count} docs, index={stats.index_kind}")
    finally:
        client.close()
        server.stop(grace=0)
        db.close()
    print("single_node_simple OK")
    return {"top3": [r.id for r in hits.results], "filtered": [r.id for r in filtered.results],
            "docs": stats.document_count}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

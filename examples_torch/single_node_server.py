"""Full single-node server on the PyTorch + CUDA port (reference
examples/single_node_server.rs): gRPC + REST + Prometheus metrics (+ optional
TLS via config), request loop until interrupted. ``main(block=False)`` runs
one self-check pass instead; that is what the example test drives.

Run: python examples_torch/single_node_server.py [--device cuda|cpu]
"""

import argparse
import json
import tempfile
import time
import urllib.request

import numpy as np

from grape_vector_db_tpu_torch import Document, VectorDatabase, VectorDbConfig
from grape_vector_db_tpu_torch.server.grpc_server import VectorDbClient, build_grpc_server
from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
from grape_vector_db_tpu_torch.server.rest import RestServer


def main(data_dir: str | None = None, block: bool = False, device: str = "cuda") -> dict:
    data_dir = data_dir or tempfile.mkdtemp(prefix="gvdb_server_")
    cfg = VectorDbConfig(vector_dimension=64)
    cfg.index.initial_capacity = 1024
    # TLS: set cfg.tls.enabled + cert/key paths to serve HTTPS/secure gRPC
    # (see tests/test_torch_server.py::test_grpc_tls_roundtrip_and_insecure_rejected).
    db = VectorDatabase(path=data_dir, config=cfg, device=device)

    server, gport, _ = build_grpc_server(db, port=0, tls=cfg.tls)
    server.start()
    rest = RestServer(db, port=0, tls=cfg.tls)
    host, rport = rest.start()
    print(f"grpc=:{gport} rest=http://{host}:{rport}")

    out = {}
    try:
        rng = np.random.default_rng(1)
        db.batch_add_documents([
            Document(id=f"d{i}", title=f"T{i}", content=f"content {i}",
                     vector=rng.standard_normal(64).astype(np.float32).tolist())
            for i in range(30)
        ])

        # REST round trip
        body = json.dumps({
            "vector": db.get_document("d3").vector, "limit": 3,
        }).encode()
        req = urllib.request.Request(
            f"http://{host}:{rport}/api/v1/search", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            results = json.loads(r.read())["results"]
        print("rest top-3:", [x["id"] for x in results])
        assert results[0]["id"] == "d3"
        out["rest_top3"] = [x["id"] for x in results]

        # Prometheus metrics
        with urllib.request.urlopen(f"http://{host}:{rport}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        assert "grape_vector_db" in text
        print("metrics lines:", len(text.splitlines()))

        # gRPC health via stats
        client = VectorDbClient(f"127.0.0.1:{gport}")
        out["docs"] = client.call("GetStats", pb.GetStatsRequest()).document_count
        print("docs:", out["docs"])
        client.close()

        while block:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        rest.stop()
        server.stop(grace=0)
        db.close()
    print("single_node_server OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(block=True, device=parser.parse_args().device)

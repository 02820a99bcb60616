"""Embedded mode quick start on the PyTorch + CUDA port (mirrors the
reference's examples/embedded_mode_simple.rs workload: create, upsert,
search, stats).

Run: python examples_torch/embedded_mode_simple.py [--device cuda|cpu]
"""

import argparse

from grape_vector_db_tpu_torch import (
    Document,
    EmbeddedConfig,
    EmbeddedVectorDB,
    SearchRequest,
    VectorDbConfig,
)


def main(device: str = "cuda") -> dict:
    cfg = EmbeddedConfig(
        data_dir="./example_data",
        db=VectorDbConfig(vector_dimension=384),
    )
    with EmbeddedVectorDB(cfg, device=device) as db:
        docs = [
            Document(id="rust", title="Rust", content="systems programming with memory safety"),
            Document(id="jax", title="JAX", content="composable function transformations on accelerators"),
            Document(id="gpu", title="GPU", content="matrix units and high bandwidth memory"),
            Document(id="pasta", title="Pasta", content="boil water, add salt, cook al dente"),
        ]
        db.upsert(docs)

        results = db.search(SearchRequest(query="accelerator programming", limit=3))
        for r in results:
            print(f"{r.score:.3f}  {r.document.id:8s} {r.snippet}")

        stats = db.stats()
        print(f"\ndocs={stats.document_count} index={stats.index_kind} "
              f"mem={stats.index_memory_mb:.1f}MB health={db.health_check().status.value}")
    return {"ids": [r.document.id for r in results], "docs": stats.document_count}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

"""Filtered + hybrid search demo on the PyTorch + CUDA port (mirrors the
reference's advanced_filtering_demo / hybrid examples): payload predicates,
SQL WHERE, geo radius, fusion strategies.

Run: python examples_torch/advanced_filtering_demo.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from grape_vector_db_tpu_torch import (
    Condition,
    Document,
    Filter,
    FusionStrategy,
    HybridSearchRequest,
    SearchRequest,
    VectorDatabase,
    VectorDbConfig,
)
from grape_vector_db_tpu_torch.engine.filtering import parse_sql_where


def main(device: str = "cuda") -> dict:
    db = VectorDatabase(config=VectorDbConfig(vector_dimension=128), device=device)
    rng = np.random.default_rng(0)
    cities = {
        "sf": (37.77, -122.42), "nyc": (40.71, -74.00), "berlin": (52.52, 13.40),
    }
    docs = []
    for i in range(300):
        city = ["sf", "nyc", "berlin"][i % 3]
        lat, lon = cities[city]
        docs.append(Document(
            id=f"shop-{i}",
            title=f"Shop {i}",
            content=f"{'coffee roastery' if i % 2 == 0 else 'book store'} number {i}",
            metadata={
                "city": city, "rating": round(1 + 4 * rng.random(), 1),
                "tags": ["coffee"] if i % 2 == 0 else ["books"],
                "loc": {"lat": lat + rng.normal(0, 0.02), "lon": lon + rng.normal(0, 0.02)},
            },
        ))
    db.batch_add_documents(docs)
    out = {}

    # structured filter
    f = Filter(must=[Condition("city", "eq", "sf"), Condition("rating", "gte", 4.0)])
    hits = db.search(SearchRequest(query="coffee", limit=5, filter=f))
    print("SF coffee, rating >= 4:", [h.document.id for h in hits])
    out["structured"] = [h.document.id for h in hits]

    # SQL WHERE
    f2 = parse_sql_where("city IN ('nyc','berlin') AND rating BETWEEN 2 AND 5")
    hits = db.search(SearchRequest(query="books", limit=5, filter=f2))
    print("SQL-filtered:", [h.document.id for h in hits])
    out["sql"] = [h.document.id for h in hits]

    # geo radius: 5km around downtown SF
    f3 = Filter(must=[Condition("loc", "geo_within_distance",
                                {"lat": 37.7749, "lon": -122.4194, "radius_m": 5000})])
    hits = db.search(SearchRequest(query="coffee", limit=5, filter=f3))
    print("within 5km of SF:", [h.document.id for h in hits])
    out["geo"] = [h.document.id for h in hits]

    # hybrid with different fusion strategies
    for strat in (FusionStrategy.RRF, FusionStrategy.LEARNED):
        res = db.hybrid_search(HybridSearchRequest(
            query="coffee roastery", limit=3, fusion_strategy=strat))
        print(f"{strat.value}: {[(r.document.id, round(r.score, 4)) for r in res]}")
        out[strat.value] = [r.document.id for r in res]
    db.close()
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

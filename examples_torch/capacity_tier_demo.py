"""Capacity-tier demo on the PyTorch + CUDA port: compressed codes on the
device, exact recall from the host store.

The capacity ladder trades device bytes a row for rank noise on the device
(codes of D dimensions, or of R after a projection; each row also keeps a
few bytes of scale):

    flat bf16 (2D bytes) > int8 IVF (D) > int4 IVF (D/2)
    > projected int8 (R) > projected int4 (R/2)

Every rung keeps the FULL-precision vector in the document store, so setting
``query.host_rescore = C`` (or per-request ``SearchParams(host_rescore=C)``)
re-ranks the device's top-C candidates exactly on the host: the served
ranking is exact over the candidate set while the device holds only codes.
This is the role the reference's BinaryVectorStore
rescore-from-stored-vectors plays (quantization.rs:286-354), generalized to
every index family. Here the ``ivf_int4`` probe is the hand-written int4
kernel of ``csrc/ivf_probe.cu`` on the card.

Run: python examples_torch/capacity_tier_demo.py [--device cuda|cpu]
"""

import argparse

import numpy as np

from grape_vector_db_tpu_torch import (
    Document,
    SearchRequest,
    VectorDatabase,
    VectorDbConfig,
)
from grape_vector_db_tpu_torch.types import SearchParams


def main(device: str = "cuda") -> dict:
    dim, n = 128, 2000
    rng = np.random.default_rng(7)
    # clustered corpus, tight at the 4-bit quantization radius: the regime
    # where code-only ranking misorders and the host tier earns its keep
    centers = rng.standard_normal((16, dim)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 16, n)]
            + 0.05 * rng.standard_normal((n, dim))).astype(np.float32)

    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.kind = "ivf_int4"           # packed nibbles: 4 bits/dim resident
    cfg.index.nlist = 16
    cfg.index.nprobe = 4
    cfg.index.int8_rescore = 0            # no device-side rescore plane ...
    cfg.index.ivf_int8_keep_bf16 = False  # ... and no bf16 shadow: codes only
    cfg.index.initial_capacity = 4096
    cfg.query.host_rescore = 256          # exact host re-rank of top-256
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg, device=device)

    db.batch_add_documents([
        Document(id=f"doc-{i}", content=f"text {i}", vector=vecs[i])
        for i in range(n)
    ])
    stats = db.stats()
    print(f"index kind: {stats.index_kind}, rows: {stats.index_size}")
    print("device-resident: packed int4 codes (~1/8 of the f32 bytes)")

    # oracle recall@10 with the host tier on vs off
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qsel = rng.choice(n, 16, replace=False)
    hit_on = hit_off = 0
    for qi in qsel:
        want = {f"doc-{j}" for j in np.argsort(-(vn[qi] @ vn.T))[:10]}
        on = db.vector_search(SearchRequest(vector=vecs[qi].tolist(), limit=10))
        off = db.vector_search(SearchRequest(
            vector=vecs[qi].tolist(), limit=10,
            params=SearchParams(host_rescore=0)))     # per-request off switch
        hit_on += len({h.id for h in on} & want)
        hit_off += len({h.id for h in off} & want)
    print(f"recall@10 codes-only device ranking : {hit_off / 160:.3f}")
    print(f"recall@10 with host_rescore=256     : {hit_on / 160:.3f}")
    assert hit_on >= hit_off
    db.close()
    return {"index": db.index, "queries": vecs[qsel], "rows": stats.index_size,
            "recall_codes_only": hit_off / 160, "recall_host_rescore": hit_on / 160}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

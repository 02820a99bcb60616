"""Binary quantization demo on the PyTorch + CUDA port: reproduces the
reference's BQ benchmark table (docs/week5-6-binary-quantization.md:
10,000 x 512-d; compression ratio, quantization time, Hamming-vs-exact
speed, recall@5 with and without rescore).

The reference's own measured numbers (its Rust debug build, on a CPU):
  compression 28.5x | quantize 926ms | search speedup 5.3x | recall@5 17%.

Run: python examples_torch/binary_quantization_demo.py [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from grape_vector_db_tpu_torch.index import BinaryDeviceIndex, FlatDeviceIndex


def main(device: str = "cuda") -> dict:
    n, d, q, k = 10_000, 512, 100, 5
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    queries = vecs[rng.integers(0, n, q)] + 0.1 * rng.standard_normal((q, d)).astype(np.float32)

    # exact baseline
    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=16384, device=device)
    flat.add_batch(ids, vecs)
    flat.search_batch(queries[:8], k)  # warm
    t0 = time.perf_counter()
    exact = flat.search_batch(queries, k)
    exact_s = time.perf_counter() - t0

    # binary quantized
    bq = BinaryDeviceIndex(d, storage_dtype="float32", initial_capacity=16384,
                           rescore_ratio=0.1, device=device)
    t0 = time.perf_counter()
    bq.add_batch(ids, vecs)
    quant_s = time.perf_counter() - t0
    bq.search_batch(queries[:8], k)
    bq.hamming_only_topk(queries[:8], k)

    t0 = time.perf_counter()
    ham = bq.hamming_only_topk(queries, k)
    ham_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = bq.search_batch(queries, k)
    two_s = time.perf_counter() - t0

    def recall(got):
        return np.mean([
            len({h[0] for h in g} & {h[0] for h in e}) / k for g, e in zip(got, exact)
        ])

    fp32_kb = n * d * 4 / 1024
    packed_kb = n * (d // 32) * 4 / 1024
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    print(f"corpus: {n} x {d} (device={name})")
    print(f"compression: {fp32_kb:.0f} KB -> {packed_kb:.0f} KB "
          f"({fp32_kb / packed_kb:.1f}x)   [reference: 28.5x]")
    print(f"quantize+ingest: {quant_s * 1e3:.0f} ms          [reference: 926 ms]")
    print(f"{q} exact searches:   {exact_s * 1e3:.0f} ms")
    print(f"{q} hamming searches: {ham_s * 1e3:.0f} ms "
          f"({exact_s / ham_s:.1f}x)   [reference speedup: 5.3x]")
    print(f"recall@5 hamming-only: {recall(ham):.1%}   [reference: 17.0%]")
    print(f"recall@5 two-stage:    {recall(two):.1%}   "
          f"(rescore fixes what the reference lost), {exact_s / two_s:.1f}x vs exact")

    # asymmetric prescan (the default): one matmul as Hamming's, but the
    # query keeps its real values against the sign codes
    asym_only = BinaryDeviceIndex(
        d, storage_dtype="float32", initial_capacity=16384,
        keep_vectors=False, prescan="asym", device=device)
    asym_only.add_batch(ids, vecs)
    asym = asym_only.search_batch(queries, k)
    print(f"recall@5 asym-only:    {recall(asym):.1%}   "
          "(codes-only capacity config, no rescore — the 32x-compression tier)")

    # auto-tune the rescore budget instead of hand-picking it: the gather is
    # per-row bound, so this finds the cheapest budget that still meets the
    # recall target on THIS corpus (VectorDatabase.tune dispatches here for
    # kind="binary")
    budget = bq.tune_rescore(k=k, target_recall=0.95)
    tuned = bq.search_batch(queries, k)
    print(f"tuned rescore budget:  {budget} rows/query "
          f"-> recall@5 {recall(tuned):.1%} (target 95%)")
    return {"recall_hamming": recall(ham), "recall_two_stage": recall(two),
            "recall_asym": recall(asym), "rescore_budget": budget,
            "recall_tuned": recall(tuned)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)

"""On-card smoke test of the PyTorch + CUDA port (grape_vector_db_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (Hopper) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, checks each against its plain
PyTorch version, drives the port's main path (flat index, cosine, bf16
storage, D=768) at 1,048,576 documents through ``VectorDatabase`` and checks
the answers against a numpy oracle, then times the kernels, the plain
versions, batch search and ingest. Every phase raises on failure. Earlier
lines report each phase; the line before the last is a JSON object with one
entry per kernel; the last line is the JSON result. Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 1 << 20          # documents on the main path: capacity 1,048,576
DIM = 768                 # the default configuration's vector_dimension
BATCH = 128               # the serving batch
INGEST_BATCH = 8192
TOL = 3e-3                # bf16 accumulation-order tolerance (ROADMAP)
SEED = 0

KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces)
    "segmax4": ("grape_vector_db_tpu_torch/csrc/segmax.cu",
                "grape_vector_db_tpu/ops/segmax_pallas.py:354"),
    "segmax2": ("grape_vector_db_tpu_torch/csrc/segmax.cu",
                "grape_vector_db_tpu/ops/segmax_pallas.py:124"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(build_log: str):
    """One line per compiled kernel from nvcc's -Xptxas -v output."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '.*segmax_kernelILi(\d)E(\w+?)EEv", line)
        if m:
            name = f"segmax{m[1]}<{'bf16' if 'bfloat16' in m[2] else 'f32'}>"
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return out


# -- phase 1 ----------------------------------------------------------------


def setup():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    from grape_vector_db_tpu_torch.ops import segmax

    nvcc = subprocess.run([segmax._find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    segmax.build_kernels()
    log(f"[setup] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({segmax.BUILD_INFO['library']})")
    for entry in ptxas_summary(str(segmax.BUILD_INFO["log"])):
        log(f"[setup] ptxas {entry}")
    a = torch.ones(4, 8, device="cuda", dtype=torch.bfloat16)
    require(torch.mm(a, a.T, out_dtype=torch.float32).dtype == torch.float32,
            "torch.mm(bf16, bf16, out_dtype=float32) did not return float32")
    return segmax


# -- phase 2 ----------------------------------------------------------------


def plane_check(name, got, want, n_vals):
    """Values within TOL; member indices equal where both neighbouring rank
    gaps exceed TOL. Returns the largest value difference."""
    vals = torch.stack([p.float() for p in got[:n_vals]])
    ref = torch.stack([p.float() for p in want[:n_vals]])
    require(torch.equal(torch.isneginf(vals), torch.isneginf(ref)),
            f"{name}: -inf positions differ")
    fin = torch.isfinite(ref)
    err = (vals - ref)[fin].abs().max().item()
    require(err <= TOL, f"{name}: max |value diff| {err} > {TOL}")
    checked = 0
    for t, (gi, wi) in enumerate(zip(got[n_vals:], want[n_vals:])):
        prev = ref[t - 1] if t else torch.full_like(ref[0], float("inf"))
        gap = torch.minimum(prev - ref[t], ref[t] - ref[t + 1]).nan_to_num(0.0)
        sure = gap > TOL
        bad = ((gi.long() != wi.long()) & sure).sum().item()
        require(bad == 0, f"{name}: {bad} member indices differ away from near ties")
        checked += sure.sum().item()
    log(f"[kernels] {name}: max_abs_err {err:.3g}, {checked} member indices "
        f"checked away from near ties, all equal")
    return err


def kernel_phase(segmax):
    """Each kernel against its plain version at the main path's shapes, then
    on an exact-arithmetic adversarial case; also times both."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    v = torch.randn(N_ROWS, DIM, device=dev, generator=gen).to(torch.bfloat16)
    valid = torch.rand(N_ROWS, device=dev, generator=gen) >= 0.05
    w = segmax.make_weight_plane(v.float().norm(dim=1), valid, "cosine")
    q = torch.nn.functional.normalize(torch.randn(BATCH, DIM, device=dev, generator=gen), dim=1)
    out = {}
    for name, kern, plain in (("segmax4", segmax.segmax4_scores, segmax.segmax4_scores_ref),
                              ("segmax2", segmax.segmax2_scores, segmax.segmax2_scores_ref)):
        got = kern(q, v, w)
        torch.cuda.synchronize()
        want = plain(q, v, w)
        if name == "segmax2":   # (m1, i1, m2) -> values first
            got, want = (got[0], got[2], got[1]), (want[0], want[2], want[1])
        err = plane_check(f"{name} [{BATCH},{DIM}] x [{N_ROWS},{DIM}] bf16", got, want,
                          4 if name == "segmax4" else 2)
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: plain(q, v, w), 5)
        k1 = cuda_ms(lambda: kern(q, v, w), 10)
        k2 = cuda_ms(lambda: kern(q, v, w), 10)
        p2 = cuda_ms(lambda: plain(q, v, w), 5)
        out[name] = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
        log(f"[times] {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
            f"(B={BATCH}, N={N_ROWS}, D={DIM}, bf16)")
    del v, valid, w, q

    # exact arithmetic: small integers, so every sum is exact in f32 and ties
    # are everywhere; duplicate rows inside one segment and one segment whose
    # rows are all invalid. Every plane must match exactly.
    rng = np.random.default_rng(SEED)
    vi = rng.integers(-2, 3, (8192, 128)).astype(np.float32)
    for m in (3, 7, 20):
        vi[4096 + 5 + 128 * m] = vi[77]
    qi = rng.integers(-2, 3, (40, 128)).astype(np.float32)
    wi = (rng.random(8192) >= 0.05).astype(np.float32)
    wi[[9 + 128 * m for m in range(32)]] = 0.0
    qi, wi = torch.from_numpy(qi).to(dev), torch.from_numpy(wi).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        vt = torch.from_numpy(vi).to(dev).to(dtype)
        for name, kern, plain in (("segmax4", segmax.segmax4_scores, segmax.segmax4_scores_ref),
                                  ("segmax2", segmax.segmax2_scores, segmax.segmax2_scores_ref)):
            got = kern(qi, vt, wi)
            torch.cuda.synchronize()
            for g, p in zip(got, plain(qi, vt, wi)):
                require(torch.equal(g.float(), p.float()),
                        f"{name} {dtype}: adversarial planes differ")
            log(f"[kernels] {name} {dtype} adversarial (ties, duplicates, invalid "
                "segment, B=40): every plane equal")
    return out


# -- phase 3 ----------------------------------------------------------------


def corpus_batches():
    rng = np.random.default_rng(SEED)
    for start in range(0, N_ROWS, INGEST_BATCH):
        yield start, rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)


def oracle(batches, queries, group_of, deep=64):
    """numpy f32 cosine over the bf16-rounded corpus: per query the top
    ``deep`` (score, row) overall and among rows with group 3."""
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    best = [np.full((len(qn), 0), -np.inf), np.zeros((len(qn), 0), np.int64)]
    best_f = [np.full((len(qn), 0), -np.inf), np.zeros((len(qn), 0), np.int64)]

    def merge(acc, s, rows):
        vals = np.concatenate([acc[0], s], axis=1)
        ids = np.concatenate([acc[1], np.broadcast_to(rows, s.shape)], axis=1)
        top = np.argpartition(-vals, deep - 1, axis=1)[:, :deep]
        acc[0] = np.take_along_axis(vals, top, axis=1)
        acc[1] = np.take_along_axis(ids, top, axis=1)

    for start, x in batches:
        xr = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        s = (qn @ xr.T) / np.linalg.norm(xr, axis=1)[None, :]
        rows = np.arange(start, start + len(x))
        merge(best, s, rows)
        g3 = group_of(rows) == 3
        merge(best_f, s[:, g3], rows[g3])
    out = []
    for vals, ids in (best, best_f):
        order = np.argsort(-vals, axis=1)
        out.append((np.take_along_axis(vals, order, axis=1),
                    np.take_along_axis(ids, order, axis=1)))
    return out


def check_hits(name, hits, o_vals, o_ids, k, exclude=frozenset()):
    """Result ids as a set against the oracle's, with the near-tie guard."""
    for r, row in enumerate(hits):
        want = [(int(i), float(s)) for i, s in zip(o_ids[r], o_vals[r])
                if int(i) not in exclude][:k]
        require(len(want) == k, f"{name}: oracle too shallow")
        got = {int(p.id[3:]): p.score for p in row}
        require(len(row) == k and len(got) == k, f"{name} q{r}: {len(row)} hits, duplicates?")
        require(not set(got) & exclude, f"{name} q{r}: a deleted id came back")
        kth = want[-1][1]
        ref = dict(want)
        for i in set(got) ^ set(ref):
            s = got.get(i, ref.get(i))
            require(abs(s - kth) <= TOL,
                    f"{name} q{r}: id {i} (score {s}) differs from the oracle away "
                    f"from the k-th score {kth}")
        for i in set(got) & set(ref):
            require(abs(got[i] - ref[i]) <= TOL,
                    f"{name} q{r}: score of {i} {got[i]} vs oracle {ref[i]}")


def main_path(segmax):
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)

    def group_of(rows):
        return rows % 10

    db = VectorDatabase(config=VectorDbConfig(vector_dimension=DIM), device="cuda")
    log(f"[main] VectorDatabase: index {db.index.kind}, metric {db.index.metric}, "
        f"storage {db.index.storage_dtype}, device {db.index.device}")
    rng = np.random.default_rng(SEED + 1)
    # half the queries lie near stored documents, half anywhere
    near = rng.choice(N_ROWS, BATCH // 2, replace=False)
    queries = np.empty((BATCH, DIM), np.float32)
    queries[BATCH // 2:] = rng.standard_normal((BATCH // 2, DIM), dtype=np.float32)
    near_pos = {int(r): i for i, r in enumerate(near)}

    segmax.reset_launch_counts()
    ingest_s = 0.0
    for start, x in corpus_batches():
        for r in range(start, start + len(x)):
            i = near_pos.get(r)
            if i is not None:
                queries[i] = x[r - start] + 0.5 * rng.standard_normal(DIM, dtype=np.float32)
        docs = [Document(id=f"doc{start + i}", content=f"doc {(start + i) % 997}",
                         vector=x[i], metadata={"g": int(group_of(start + i))})
                for i in range(len(x))]
        t0 = time.perf_counter()
        db.batch_add_documents(docs)
        ingest_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    require(len(db.index) == N_ROWS and db.index.capacity == N_ROWS,
            f"index holds {len(db.index)} rows at capacity {db.index.capacity}")
    log(f"[main] ingested {N_ROWS} documents in {ingest_s:.2f} s "
        f"({N_ROWS / ingest_s:.0f} docs/s, batches of {INGEST_BATCH}); capacity "
        f"{db.index.capacity}, {db.index.get_stats().memory_usage_mb:.0f} MB on the device")

    batch = db.vector_search_batch(queries, 10)
    single = [db.vector_search(SearchRequest(vector=queries[i].tolist(), limit=3))
              for i in range(4)]
    filt = Filter(must=[Condition("g", "eq", 3)])
    filtered = [db.vector_search(SearchRequest(vector=queries[i].tolist(), limit=10,
                                               filter=filt)) for i in range(4)]
    # delete 1000 documents, the current top hits first
    doomed = list(dict.fromkeys(int(p.id[3:]) for row in batch for p in row))[:1000]
    taken = set(doomed)
    doomed += [i for i in range(N_ROWS) if i not in taken][:1000 - len(doomed)]
    n_del = db.batch_delete_documents([f"doc{i}" for i in doomed])
    require(n_del == 1000, f"deleted {n_del} documents, wanted 1000")
    after = db.vector_search_batch(queries, 10)
    torch.cuda.synchronize()
    launches = dict(segmax.LAUNCHES)
    log(f"[main] searches done: batch B={BATCH} k=10, 4 x k=3, 4 x filtered k=10, "
        f"deleted 1000, batch again; kernel launches {launches}")
    for name in KERNELS:
        require(launches[name] > 0, f"the main path never launched {name}")

    (o_vals, o_ids), (f_vals, f_ids) = oracle(corpus_batches(), queries, group_of)
    check_hits("batch k=10", batch, o_vals, o_ids, 10)
    check_hits("single k=3", single, o_vals[:4], o_ids[:4], 3)
    check_hits("filtered k=10", filtered, f_vals[:4], f_ids[:4], 10)
    require(all(int(p.id[3:]) % 10 == 3 for row in filtered for p in row),
            "a filtered result broke the filter")
    check_hits("after delete k=10", after, o_vals, o_ids, 10, exclude=frozenset(doomed))
    top1 = sum(int(batch[i][0].id[3:]) == int(near[i]) for i in range(BATCH // 2))
    log(f"[main] all answers agree with the numpy oracle (f32 cosine over the "
        f"bf16-rounded corpus, tolerance {TOL}); near-document queries found their "
        f"document first {top1}/{BATCH // 2}")

    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        db.vector_search_batch(queries, 10)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"[times] vector_search_batch B={BATCH} k=10 at {N_ROWS - 1000} documents: "
        f"median {med * 1e3:.3f} ms of 20 ({BATCH / med:.0f} queries/s); "
        f"ingest {N_ROWS / ingest_s:.0f} docs/s")
    db.close()
    return launches


def main():
    segmax = setup()
    kernel_stats = kernel_phase(segmax)
    torch.cuda.empty_cache()
    launches = main_path(segmax)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **kernel_stats[name]}
        for name, (src, tpu) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""One run of one cell: generate, ingest, warm up, measure, judge, read.

The order matters to what is reported. The device's peak memory is read
once the window closes, before the reference runs; the program's database
is closed and freed before the reference regenerates the corpus and judges
the answers the window kept.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.harness import data, peaks, stats
from portbench.harness.bench import Cell, load_module
from portbench.harness.trace import DeviceTrace, Spans, summarize

#: Modules the measured process may not hold, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "grape_vector_db_tpu")
#: Spans of the traced run, innermost first.
SPANS = ["index.device", "index.hits", "index", "planner"]
#: The rehearsal's sizes (CPU, ``--rehearse``): small enough for a test,
#: with every call's answers kept and at most four of them judged.
REHEARSAL = {"rows": 16384, "centres": 512, "query_set": 200, "check_stride": 1,
             "max_checked": 4}
#: Stored documents read back after the window, drawn from the seed.
READ_BACK = 256
BREAKDOWN_ENTRIES = 10


class NoTrace:
    """The rehearsal's stand-in for the device trace: the driver pauses for
    the slice all the same, and nothing is read."""

    trace = t_mark0 = None

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def db_config(values: dict):
    """A ``VectorDbConfig`` with the configuration file's ``db`` values set
    over its defaults; a key the config class lacks is an error."""
    from grape_vector_db_tpu_torch import VectorDbConfig

    def apply(obj, vals: dict, path: str) -> None:
        for key, val in vals.items():
            if not hasattr(obj, key):
                raise KeyError(f"VectorDbConfig has no {path}{key}")
            cur = getattr(obj, key)
            if isinstance(val, dict) and dataclasses.is_dataclass(cur):
                apply(cur, val, f"{path}{key}.")
            else:
                setattr(obj, key, val)

    cfg = VectorDbConfig()
    apply(cfg, values, "")
    return cfg


def check_attrs(index, attrs: dict) -> None:
    """The built index runs as the configuration states, or the run stops."""
    for key, want in attrs.items():
        got = getattr(index, key)
        if got != want:
            raise RuntimeError(f"the index has {key}={got!r}; the configuration states {want!r}")


def ingest(db, x: np.ndarray, batch: int) -> float:
    """Every row as a document with an int metadata field, in batches
    through ``batch_add_documents``; returns the seconds it took."""
    from grape_vector_db_tpu_torch import Document

    t0 = time.perf_counter()
    for lo in range(0, x.shape[0], batch):
        db.batch_add_documents([Document(id=str(i), vector=x[i], metadata={"id": i})
                                for i in range(lo, min(lo + batch, x.shape[0]))])
    return time.perf_counter() - t0


def read_back(db, rows: int, seed: int) -> int:
    """Acknowledged writes that cannot be read back: documents the index or
    the store lacks, and a seeded sample read through ``get_document``."""
    missing = abs(rows - len(db.index)) + abs(rows - db.store.count())
    rng = np.random.default_rng(data.stream_seed(seed, 4))
    for i in rng.choice(rows, min(READ_BACK, rows), replace=False):
        doc = db.get_document(str(int(i)))
        if doc is None or doc.metadata.get("id") != int(i):
            missing += 1
    return missing


def answers(res, batch: int, k: int):
    """A call's answers as ids [B, k] (-1 where missing or not a row number)
    and scores [B, k], and the count of answers beyond k or beyond B."""
    ids = np.full((batch, k), -1, np.int64)
    scores = np.full((batch, k), np.nan, np.float32)
    extra = max(len(res) - batch, 0)
    for b, row in enumerate(res[:batch]):
        extra += max(len(row) - k, 0)
        for j, p in enumerate(row[:k]):
            ids[b, j] = int(p.id) if p.id.isdigit() else -1
            scores[b, j] = p.score
    return ids, scores, extra


def fold(out: Dict[str, float], got: Dict[str, float]) -> None:
    """Add one call's numbers to the run's: the bad answers summed, and
    every other number a reference's ``judge`` gives (a gap, or the share
    of the exact top k an approximate index missed) the widest;
    ``distinct_rows`` is averaged by ``judge_window``."""
    for name, value in got.items():
        if name == "bad_hits":
            out[name] = out.get(name, 0) + value
        elif name != "distinct_rows":
            out[name] = max(out.get(name, value), value)


def judge_limits(numbers: Dict[str, float], limits: dict) -> Tuple[dict, bool]:
    """Each number compared beside its limit (``limits/<cell>.json``), and
    whether every one lies within it."""
    checks = {name: {"value": numbers[name], "limit": lim["limit"]}
              for name, lim in limits.items() if name in numbers}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


class GcWatch:
    """The cyclic garbage collector's passes while it is entered, as
    ``(generation, start, stop)`` on ``time.perf_counter``'s clock: each
    holds the interpreter, and so every caller, for its length."""

    def __init__(self) -> None:
        self.events: List[tuple] = []
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.events.append((info["generation"], self._t0, time.perf_counter()))

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def window_profile(done: List[tuple], batch: int, t_start: float, seconds: float,
                   gc_events: List[tuple], parts: int = 5) -> str:
    """The window's rate in each of ``parts`` equal slices (by the calls'
    return), and the collector's passes in each slice by generation: where a
    slow slice lines up with a long pass, the collector paced it."""
    width = seconds / parts
    rate, passes = [0.0] * parts, [[0, 0, 0, 0.0] for _ in range(parts)]
    for _, _, t1, _ in done:
        rate[min(int((t1 - t_start) / width), parts - 1)] += batch / width
    for gen, g0, g1 in gc_events:
        if t_start <= g0 < t_start + seconds:
            p = passes[min(int((g0 - t_start) / width), parts - 1)]
            p[gen] += 1
            p[3] += g1 - g0
    return "window slices: " + "; ".join(
        f"{r:.1f} queries/s, gc passes {p[0]}/{p[1]}/{p[2]} in {p[3]:.4f} s"
        for r, p in zip(rate, passes))


def judge_window(cell: Cell, ds: dict, seed: int, device, checksum: float,
                 batches, checked: Dict[int, tuple]) -> Dict[str, float]:
    """Regenerate the corpus, and hold each kept call's answers to the
    reference: the widest gaps over the calls, the bad answers summed."""
    import torch

    ref = cell.reference()
    corpus = data.make_corpus(ds, seed, device)
    if corpus.checksum != checksum:
        raise RuntimeError("the regenerated corpus differs from the one ingested")
    rows = ref.prepare(corpus.x, cell.config)
    del corpus
    k = int(cell.traffic["k"])
    out = {"score_gap": 0.0, "rank_gap": 0.0, "bad_hits": 0}
    distinct = []
    for j, (ids, scores, extra) in sorted(checked.items()):
        got = ref.judge(rows, cell.config, batches[j % len(batches)], k, ids, scores)
        fold(out, got)
        out["bad_hits"] += extra
        if "distinct_rows" in got:
            distinct.append(got["distinct_rows"])
    del rows
    if device != "cpu":
        torch.cuda.empty_cache()
    out["checked_calls"] = len(checked)
    if distinct:
        out["distinct_rows"] = float(np.mean(distinct))
    return out


def power_limit() -> Optional[str]:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout.strip() else None


def sizes(cell: Cell, rehearse: bool):
    """The cell's dataset and traffic parameters, cut to ``REHEARSAL`` in a
    rehearsal."""
    ds, traffic = dict(cell.config["dataset"]), dict(cell.traffic)
    if rehearse:
        ds["rows"] = min(ds["rows"], REHEARSAL["rows"])
        ds["centres"] = min(ds["centres"], REHEARSAL["centres"])
        for key in ("query_set", "check_stride", "max_checked"):
            traffic[key] = min(traffic[key], REHEARSAL[key])
    return ds, traffic


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, rehearse: bool = False,
             t_start: Optional[float] = None) -> dict:
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = "cpu" if rehearse else "cuda"
    ds, traffic = sizes(cell, rehearse)
    rows, batch, k = int(ds["rows"]), int(traffic["batch"]), int(traffic["k"])

    t0 = time.perf_counter()
    corpus = data.make_corpus(ds, seed, device)
    queries = data.make_queries(corpus, ds, traffic, seed)
    x_host, checksum = corpus.x.cpu().numpy(), corpus.checksum
    del corpus
    batches = [np.ascontiguousarray(queries[r]) for r in data.batch_rows(len(queries), batch)]
    if not rehearse:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(f"{rows} x {ds['dim']} corpus and {len(queries)} queries made in "
        f"{time.perf_counter() - t0:.2f} s")

    from grape_vector_db_tpu_torch import VectorDatabase

    db = VectorDatabase(config=db_config(cell.config["db"]), device=device)
    check_attrs(db.index, cell.config.get("index_attrs", {}))
    ingest_s = ingest(db, x_host, int(cell.config["ingest"]["batch"]))
    log(f"ingested {rows} documents in {ingest_s:.2f} s ({rows / ingest_s:.0f} docs/s)")
    # as VectorDBBench's load ends: a trained index sizes its lists here;
    # flat and binary keep the base class's no-op
    t0 = time.perf_counter()
    db.optimize()
    log(f"optimized the index in {time.perf_counter() - t0:.2f} s")

    spans = Spans() if trace else None
    target = db.vector_search_batch
    if trace:
        target = spans.wrap(target, "planner")
        spans.wrap_method(db.index, "search_batch", "index")
        # kinds that search in one piece (IVF, graph) have neither
        for attr, name in (("raw_topk", "index.device"), ("hits_from_slots", "index.hits")):
            if hasattr(db.index, attr):
                spans.wrap_method(db.index, attr, name)
    dtrace = None
    if trace:
        dtrace = NoTrace() if rehearse else DeviceTrace(torch, device)
    with GcWatch() as gcw:
        window = cell.driver().run(target, batches, traffic, seconds,
                                   data.stream_seed(seed, 2), tracer=dtrace)
    setup_s = window["t_start"] - t_start
    peak = 0 if rehearse else int(torch.cuda.max_memory_allocated())
    calls, deadline = window["calls"], window["deadline"]
    done = [c for c in calls if c[3] and c[2] <= deadline]
    failed = sum(1 for c in calls if not c[3])
    for e in window["errors"]:
        log(f"failed {e}")
    log(f"setup {setup_s:.2f} s; {len(calls)} calls in the window, {len(done)} completed "
        f"by its close, {failed} failed")
    log(window_profile(done, batch, window["t_start"], seconds, gcw.events))

    rng = np.random.default_rng(data.stream_seed(seed, 3))
    kept = sorted(window["kept"])
    limit = int(traffic.get("max_checked", len(kept)))
    chosen = sorted(rng.choice(kept, min(limit, len(kept)), replace=False)) if kept else []
    checked = {int(j): answers(window["kept"][j], batch, k) for j in chosen}
    ingest_missing = read_back(db, rows, seed)
    db.close()
    del db, target, window["kept"]
    gc.collect()
    numbers = judge_window(cell, ds, seed, device, checksum, batches, checked)
    numbers["ingest_missing"] = ingest_missing

    checks, within = judge_limits(numbers, cell.limits)
    correct = failed == 0 and not window["errors"] and len(checked) > 0 and within

    result = {"correct": bool(correct), "attempted": len(calls), "failed": failed,
              "metrics": {}}
    if rehearse:
        result["device"] = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0,
                            "memory_peak_bytes": 0}
        result["rehearsal"] = {"calls": len(calls), "completed": len(done),
                               "checked_calls": numbers["checked_calls"],
                               "spans": len(spans.records) if spans else 0}
    else:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips, "memory_peak_bytes": peak}
        pl = power_limit()
        if pl:
            result["device"]["power_limit"] = pl
        if trace:
            summary = summarize(dtrace.trace, dtrace.t_mark0, spans, SPANS)
            s0, s1 = window["traced"]
            ctx = SimpleNamespace(cell=cell, rows=rows, dim=int(ds["dim"]), batch=batch, k=k,
                                  calls=[c for c in calls if s0 <= c[1] < s1],
                                  t_start=window["t_start"], spans=spans, trace=summary,
                                  numbers=numbers)
            result["metrics"] = per_layer(cell, ctx)
            if summary is not None:
                result["device"]["busy_s"] = summary.busy_s
                result["device"]["window_s"] = summary.window_s
                result["breakdown"] = {"device_ops": [list(o) for o in
                                                      summary.ops[:BREAKDOWN_ENTRIES]],
                                       "idle_gaps": [list(g) for g in
                                                     summary.idle[:BREAKDOWN_ENTRIES]]}
        else:
            result["metrics"] = end_to_end(cell, done, batch, seconds, setup_s)
    result["checks"] = checks
    return result


def end_to_end(cell: Cell, done: List[tuple], batch: int, seconds: float,
               setup_s: float) -> dict:
    lat_ms = [(t1 - t0) * 1e3 for _, t0, t1, _ in done]
    values = {"search_qps": len(done) * batch / seconds,
              "batch_p95_ms": stats.percentile(lat_ms, 95) if lat_ms else None,
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


def per_layer(cell: Cell, ctx) -> dict:
    """Each of the cell's per-layer metrics from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    ctx.work = lambda name: load_module("work", name).work(ctx)
    ctx.least_seconds = peaks.least_seconds
    out = {}
    for m in cell.per_layer:
        v = load_module("metrics", m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def emit(result: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

"""The harness on the CPU: the rehearsal end to end, the arithmetic of the
metrics, the reading of a device trace, and what the benchmark may import.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""

import ast
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import bench, peaks, runner, stats, trace  # noqa: E402

BENCH = os.path.join(ROOT, "portbench")
CELLS = [w["name"] for w in bench.read_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_runs_a_cell_end_to_end_and_reports_no_metric(name):
    cell = bench.load_cell(name)
    res = runner.run_cell(cell, seed=2**31 + 7, seconds=0.5, trace=False, rehearse=True)
    assert res["correct"] is True
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert res["rehearsal"]["checked_calls"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell.limits)


def test_traced_rehearsal_records_the_layers_spans():
    cell = bench.load_cell("flat1m.batch1000-k10")
    res = runner.run_cell(cell, seed=11, seconds=0.5, trace=True, rehearse=True)
    assert res["correct"] is True and res["metrics"] == {}
    assert res["rehearsal"]["spans"] >= 4 * res["rehearsal"]["calls"]


@pytest.mark.parametrize("name", CELLS)
def test_optimize_runs_once_after_the_last_batch_before_the_window(name, monkeypatch):
    from grape_vector_db_tpu_torch import VectorDatabase

    cell = bench.load_cell(name)
    seen, windows = [], []
    orig_optimize, drv = VectorDatabase.optimize, cell.driver()
    orig_run = drv.run

    def spy_optimize(self):
        seen.append((time.perf_counter(), len(self.index)))
        return orig_optimize(self)

    def spy_run(*args, **kwargs):
        windows.append(orig_run(*args, **kwargs))
        return windows[-1]

    monkeypatch.setattr(VectorDatabase, "optimize", spy_optimize)
    monkeypatch.setattr(drv, "run", spy_run)
    res = runner.run_cell(cell, seed=2**31 + 19, seconds=0.5, trace=False, rehearse=True)
    assert res["correct"] is True
    (t, stored), = seen
    assert stored == runner.REHEARSAL["rows"]   # after the last batch
    assert t < windows[0]["t_start"]


#: A trained kind's deployment at a small nlist, with the ratio of
#: VectorDBBench's 1M corpus over nlist 4,096: a mean of 256 rows a list
#: against a first list capacity of 128.
IVF_CONFIG = {
    "name": "ivf-test",
    "dataset": {"rows": 16384, "dim": 128, "metric": "cosine", "centres": 512, "noise": 0.25},
    "db": {"vector_dimension": 128, "distance": "cosine",
           "index": {"kind": "ivf", "initial_capacity": 4096, "nlist": 64, "nprobe": 8},
           "device": {"storage_dtype": "bfloat16", "growth_factor": 2,
                      "search_mode": "exact"}},
    "index_attrs": {"kind": "ivf", "nlist": 64, "nprobe": 8},
    "ingest": {"batch": 8192},
}


class IvfStandIn:
    """A reference of the IVF cell to come, judged as VectorDBBench judges
    an approximate index: by the share of the exact top k (the flat
    reference's, from the corpus alone) that a call's answers miss, beside
    ``flat.judge``'s score gap and faulty answers. It reads nothing of the
    index."""

    def __init__(self):
        self.flat = bench.load_module("reference", "flat")
        self.C = bench.load_module("reference", "common")

    def prepare(self, x, config):
        return self.flat.prepare(x, config)

    def judge(self, rows, config, queries, k, ids, scores):
        got = self.flat.judge(rows, config, queries, k, ids, scores)
        qu = self.C.unit_queries(queries, rows.x.device, config["db"]["device"]["storage_dtype"])
        exact = self.flat.exact_topk(qu, rows, k)[1].cpu().numpy()
        hit = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, exact))
        return {"score_gap": got["score_gap"], "bad_hits": got["bad_hits"],
                "recall_miss": 1.0 - hit / exact.size}

    def control(self, rows, config, queries, k):
        return self.flat.control(rows, config, queries, k)


IVF_LIMITS = {"score_gap": {"limit": 2e-4}, "recall_miss": {"limit": 0.5},
              "bad_hits": {"limit": 0}, "ingest_missing": {"limit": 0}}


def ivf_cell():
    cell = bench.Cell(name="ivf-test.batch1000-k10", chips=1, config=IVF_CONFIG,
                      traffic=bench.load_cell("flat1m.batch1000-k10").traffic,
                      limits=IVF_LIMITS, end_to_end=[], per_layer=[])
    cell.reference = IvfStandIn
    return cell


@pytest.fixture(scope="module")
def ivf_traced():
    """One traced rehearsal of the IVF cell: its result, its spans, and the
    overflow region's rows once the set-up's ``optimize()`` returned."""
    from grape_vector_db_tpu_torch import VectorDatabase

    made, overflow = [], []
    orig_optimize = VectorDatabase.optimize

    class KeptSpans(trace.Spans):
        def __init__(self):
            super().__init__()
            made.append(self)

    def spy_optimize(self):
        orig_optimize(self)
        overflow.append(len(self.index._overflow))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "Spans", KeptSpans)
        mp.setattr(VectorDatabase, "optimize", spy_optimize)
        res = runner.run_cell(ivf_cell(), seed=2**31 + 23, seconds=0.5, trace=True,
                              rehearse=True)
    return res, made[0], overflow


def test_a_traced_run_wraps_only_the_methods_the_index_has(ivf_traced):
    res, spans, overflow = ivf_traced
    assert res["correct"] is True and res["rehearsal"]["checked_calls"] >= 1
    assert overflow == [0]                  # the load's optimize() absorbed it
    names = {r[0] for r in spans.records}
    assert {"planner", "index"} <= names
    assert "index.device" not in names and "index.hits" not in names


def test_the_ivf_ingest_spills_until_optimize():
    from grape_vector_db_tpu_torch import VectorDatabase

    x = np.random.default_rng(5).standard_normal((16384, 128)).astype(np.float32)
    db = VectorDatabase(config=runner.db_config(IVF_CONFIG["db"]), device="cpu")
    try:
        runner.ingest(db, x, IVF_CONFIG["ingest"]["batch"])
        assert len(db.index._overflow) > 0 and db.index.list_cap == 128
        db.optimize()
        assert len(db.index._overflow) == 0 and db.index.list_cap > 128
    finally:
        db.close()


def test_a_number_of_the_references_own_reaches_the_checks(ivf_traced):
    from portbench import calibrate

    res, _, _ = ivf_traced
    assert set(res["checks"]) == set(IVF_LIMITS)
    assert 0.0 <= res["checks"]["recall_miss"]["value"] <= 0.5
    numbers = calibrate.control_numbers(ivf_cell(), seed=2**31 + 23, device="cpu",
                                        rehearse=True)
    checks, _ = runner.judge_limits(numbers, IVF_LIMITS)
    assert {"score_gap", "recall_miss", "bad_hits"} <= set(checks)


def test_fold_sums_faults_and_keeps_the_widest_of_every_other_number():
    out = {"score_gap": 0.0, "rank_gap": 0.0, "bad_hits": 0}
    runner.fold(out, {"score_gap": 2e-5, "bad_hits": 1, "recall_miss": 0.1,
                      "distinct_rows": 7})
    runner.fold(out, {"score_gap": 1e-5, "bad_hits": 2, "recall_miss": 0.3,
                      "distinct_rows": 9})
    assert out == {"score_gap": 2e-5, "rank_gap": 0.0, "bad_hits": 3, "recall_miss": 0.3}


def test_run_py_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    sys.path.insert(0, BENCH)
    import run

    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == ""


def test_every_cell_finds_its_files_by_name():
    spec = bench.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in spec["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.driver().run
        assert cell.reference().judge and cell.reference().control
    for m in spec["per_layer"]:
        assert bench.load_module("metrics", m["name"]).read


def test_flat_scan_work_counts_the_stored_rows_once():
    ctx = SimpleNamespace(rows=1_000_000, dim=768, batch=128, k=10,
                          cell=bench.load_cell("flat1m.batch1000-k10"))
    nbytes, ops = bench.load_module("work", "flat_scan").work(ctx)
    assert nbytes == 1_000_000 * (768 * 2 + 5) + 128 * 768 * 4 + 128 * 10 * 12
    assert ops == 2 * 128 * 1_000_000 * 768
    # bytes bound at B=128: 1.541 GB over 3.35 TB/s
    assert peaks.least_seconds(nbytes, ops) == pytest.approx(nbytes / 3.35e12)
    ctx.batch = 512
    nbytes, ops = bench.load_module("work", "flat_scan").work(ctx)
    assert peaks.least_seconds(nbytes, ops) == pytest.approx(ops / 989e12)


def test_binary_work_needs_the_reference_count_of_distinct_rows():
    cell = bench.load_cell("binary1m.serial-k100")
    ctx = SimpleNamespace(rows=1_000_000, dim=768, batch=128, k=10, cell=cell, numbers={})
    w = bench.load_module("work", "binary_search")
    assert w.work(ctx) is None
    ctx.numbers["distinct_rows"] = 400_000.0
    nbytes, ops = w.work(ctx)
    assert nbytes == 1_000_000 * (24 * 4 + 1) + 128 * 768 * 4 + 400_000 * (768 * 2 + 4) + 128 * 10 * 12
    assert ops == 2 * 128 * 1_000_000 * 768 + 2 * 128 * 4096 * 768


def test_rescore_rows_follows_the_configuration():
    ref = bench.load_module("reference", "binary")
    cfg = bench.load_cell("binary1m.serial-k100").config
    assert ref.rescore_rows(cfg, 1_000_000, 10) == 4096
    assert ref.rescore_rows(cfg, 16_384, 10) == 2048
    assert ref.rescore_rows(cfg, 100, 10) == 64


def test_percentile():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def synthetic_trace():
    """Markers at 0 and 1000 us, kernels busy 100-300 and 250-400 (union
    100-400), a copy 600-700: busy 400 us of a 1001 us window."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "marker", "ts": 0.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "scan", "ts": 100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "topk", "ts": 250.0, "dur": 150.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 600.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "marker", "ts": 1000.0, "dur": 1.0},
    ]
    return {"traceEvents": ev}


def test_device_idle_from_a_synthetic_trace():
    sp = trace.Spans()
    # one caller: in the index from 0 to 600 us (its hits from 400), in the
    # planner until 900 us
    sp.records += [("planner", 1, 10.0, 10.0009), ("index", 1, 10.0, 10.0006),
                   ("index.hits", 1, 10.0004, 10.0006)]
    s = trace.summarize(synthetic_trace(), 10.0, sp, runner.SPANS)
    assert s.window_s == pytest.approx(1001e-6)
    assert s.busy_s == pytest.approx(400e-6)
    assert s.device_s == pytest.approx(450e-6)
    assert s.n_kernels == 2
    assert s.ops[0] == ("scan", pytest.approx(200e-6))
    idle = dict(s.idle)
    assert idle["index.hits"] == pytest.approx(200e-6)     # 400-600 us
    assert idle["index"] == pytest.approx(100e-6)          # 0-100 us (the gap's middle)
    assert idle["planner"] == pytest.approx(301e-6)        # 700-1001 us
    ctx = SimpleNamespace(trace=s, calls=[(0, 0.0, 1.0, True), (1, 0.0, 1.0, True)],
                          work=lambda name: (3.35e12 * 90e-6, 0.0),
                          least_seconds=peaks.least_seconds)
    read = lambda m: bench.load_module("metrics", m).read(ctx)  # noqa: E731
    assert read("device_idle") == pytest.approx(100 * (1 - 400 / 1001))
    assert read("kernels_per_call") == 1.0
    # two calls of 90 us least time over 450 us of device time
    assert read("flat_scan_roofline") == pytest.approx(40.0)


def test_a_trace_without_device_work_reads_nothing():
    t = {"traceEvents": synthetic_trace()["traceEvents"][:1]}
    assert trace.summarize(t, 0.0, None, runner.SPANS) is None
    ctx = SimpleNamespace(trace=None, calls=[(0, 0.0, 1.0, True)])
    for m in ("device_idle", "kernels_per_call", "flat_scan_roofline"):
        assert bench.load_module("metrics", m).read(ctx) is None


def test_host_spans_give_the_planner_and_index_means():
    sp = trace.Spans()
    sp.records += [("planner", 1, 1.0, 1.010), ("index", 1, 1.001, 1.007),
                   ("planner", 2, 1.0, 1.020), ("index", 2, 1.002, 1.016),
                   ("planner", 1, 0.5, 0.6)]                # before the window
    ctx = SimpleNamespace(spans=sp, t_start=0.9)
    assert bench.load_module("metrics", "planner_ms").read(ctx) == pytest.approx(5.0)
    assert bench.load_module("metrics", "index_ms").read(ctx) == pytest.approx(10.0)


def imports_of(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    forbidden = set(runner.FORBIDDEN)
    for path in py_files(BENCH):
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert not tops & forbidden, (path, tops & forbidden)


def test_the_reference_imports_nothing_of_the_program():
    for path in py_files(os.path.join(BENCH, "reference")):
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert tops <= {"__future__", "dataclasses", "typing", "numpy", "torch", "portbench"}, \
            (path, tops)
        portbench = {m for m in imports_of(path) if m.split(".")[0] == "portbench"}
        assert portbench <= {"portbench.reference"}, (path, portbench)


def test_benchmark_json_keeps_to_the_contract_shape():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names
    for m in spec["per_layer"]:
        assert m["moves"] in names
        assert m["name"].endswith("_roofline") == (m["unit"] == "%" and "roofline" in m["name"])
    for c in spec["configs"]:
        assert len(c["source"]) <= 200
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert os.path.isfile(os.path.join(BENCH, "limits", w["name"] + ".json"))


def test_judge_limits_compares_each_number_present_with_its_limit():
    limits = {"score_gap": {"limit": 1e-4}, "bad_hits": {"limit": 0},
              "ingest_missing": {"limit": 0}}
    checks, within = runner.judge_limits({"score_gap": 5e-5, "bad_hits": 0}, limits)
    assert within and set(checks) == {"score_gap", "bad_hits"}
    assert checks["score_gap"] == {"value": 5e-5, "limit": 1e-4}
    checks, within = runner.judge_limits({"score_gap": 5e-5, "bad_hits": 1}, limits)
    assert not within


def test_window_profile_puts_calls_and_collector_passes_in_their_slice():
    done = [(j, 0.0, 100.0 + t, True) for j, t in enumerate([0.5, 1.5, 1.6, 4.9])]
    gc_events = [(0, 100.2, 100.201), (2, 101.7, 102.7), (1, 99.0, 99.5)]
    line = runner.window_profile(done, 10, 100.0, 5.0, gc_events)
    parts = line.split(": ", 1)[1].split("; ")
    assert parts[0] == "10.0 queries/s, gc passes 1/0/0 in 0.0010 s"
    assert parts[1] == "20.0 queries/s, gc passes 0/0/1 in 1.0000 s"
    assert parts[4].startswith("10.0 queries/s, gc passes 0/0/0")


def test_gc_watch_records_a_full_collection():
    import gc

    with runner.GcWatch() as w:
        gc.collect()
    assert any(gen == 2 and t1 >= t0 for gen, t0, t1 in w.events)
    assert w not in gc.callbacks

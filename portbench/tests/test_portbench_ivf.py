"""The IVF cell (``ivf1m.batch1000-k10``) on the CPU: ``run.py --rehearse``
end to end, the least work of a call, and the readers of its five metrics,
which read nothing where the program records nothing (as a program without
the IVF search's spans does).

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""

import functools
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import bench, peaks, trace  # noqa: E402

CELL = "ivf1m.batch1000-k10"
METRICS = ["ivf_search_roofline", "ivf_probe_ms", "ivf_launch_ms", "ivf_readback_ms",
           "ivf_hits_ms"]


def test_run_py_rehearses_the_ivf_cell():
    """``run.py --rehearse`` in a process of its own, as the benchmark runs."""
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                           str(2**31 + 29), "--seconds", "0.5", "--rehearse"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["metrics"] == {}
    assert set(res["checks"]) == {"score_gap", "recall_miss", "bad_hits", "ingest_missing"}
    assert res["checks"]["bad_hits"]["value"] == 0


def alter_one_id(main, vals, slots, qp, k):
    slots[0, 1] = slots[1, 1]
    return vals, slots


def alter_one_score(main, vals, slots, qp, k):
    vals[0, 0] += 1e-3
    return vals, slots


def half_batch_left_out(main, vals, slots, qp, k):
    h = qp.shape[0] // 2
    v, s = main(qp[:h], k, None)
    return torch.cat([v, v]), torch.cat([s, s])


def lists_left_out(main, vals, slots, qp, k):
    """Every other list left out of the scan."""
    index = main.args[0]
    keep = np.ones((index.nlist, index.list_cap), bool)
    keep[1::2] = False
    return main(qp, k, (keep, None))


@pytest.mark.parametrize("fault", [alter_one_id, alter_one_score, half_batch_left_out,
                                   lists_left_out], ids=lambda f: f.__name__)
def test_a_broken_ivf_search_comes_out_not_correct(fault, monkeypatch):
    """The faults ``test_portbench_checks.py`` plants in the flat and binary
    searches, planted where the IVF search produces its answers."""
    from grape_vector_db_tpu_torch.index.ivf import IvfDeviceIndex

    from portbench.harness import runner

    orig = IvfDeviceIndex._main_topk

    def main_topk(self, qp, k, mask, nprobe=None):
        vals, slots = orig(self, qp, k, mask, nprobe=nprobe)
        return fault(functools.partial(orig, self), vals.clone(), slots.clone(), qp, k)

    monkeypatch.setattr(IvfDeviceIndex, "_main_topk", main_topk)
    res = runner.run_cell(bench.load_cell(CELL), seed=321, seconds=0.5, trace=False,
                          rehearse=True)
    assert res["correct"] is False, res["checks"]


def test_the_cell_lists_its_five_metrics_and_nothing_else_does():
    cell = bench.load_cell(CELL)
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert cell.config["db"]["index"]["kind"] == "ivf" and cell.chips == 1
    for other in ("flat1m.batch1000-k10", "binary1m.serial-k100"):
        assert not set(METRICS) & {m["name"] for m in bench.load_cell(other).per_layer}


def test_ivf_search_work_at_the_cells_size():
    ctx = SimpleNamespace(rows=1_000_000, dim=768, batch=1000, k=10,
                          cell=bench.load_cell(CELL))
    nbytes, ops = bench.load_module("work", "ivf_search").work(ctx)
    probed = 4096 * (1 - (1 - 16 / 4096) ** 1000)
    assert probed == pytest.approx(4014.2, abs=0.1)          # ~98% of the lists
    assert nbytes == pytest.approx(probed * 1_000_000 / 4096 * (768 * 2 + 4)
                                   + 4096 * 768 * 4 + 1000 * 768 * 4 + 1000 * 10 * 12)
    assert nbytes == pytest.approx(1.525e9, rel=1e-3)
    assert ops == 2 * 1000 * 768 * (4096 + 16 * 1_000_000 / 4096)
    # bound by the bytes: ~0.455 ms
    assert peaks.least_seconds(nbytes, ops) == pytest.approx(nbytes / 3.35e12)


def summary(ops):
    return trace.TraceSummary(window_s=1.0, busy_s=0.5, device_s=0.004, n_kernels=8,
                              ops=ops, idle=[])


def test_ivf_probe_ms_sums_the_probe_kernels_per_call():
    ops = [("probe_kernel<(Fmt)0>", 0.003), ("gatherTopK", 0.0008),
           ("int8_probe_kernel", 0.0002), ("Memcpy DtoH", 0.0001)]
    ctx = SimpleNamespace(trace=summary(ops),
                          calls=[(0, 0.0, 1.0, True), (1, 1.0, 2.0, True), (2, 2.0, 3.0, False)])
    assert bench.load_module("metrics", "ivf_probe_ms").read(ctx) == pytest.approx(1.6)
    ctx.trace = summary([("gatherTopK", 0.001)])
    assert bench.load_module("metrics", "ivf_probe_ms").read(ctx) is None


def test_ivf_search_roofline_divides_the_least_time_by_the_device_time():
    ctx = SimpleNamespace(trace=summary([]), calls=[(0, 0.0, 1.0, True), (1, 1.0, 2.0, True)],
                          work=lambda name: (3.35e12 * 1e-3, 0.0),
                          least_seconds=peaks.least_seconds)
    # two calls of 1 ms least time over 4 ms of device time
    assert bench.load_module("metrics", "ivf_search_roofline").read(ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_reads_nothing_without_a_trace_or_spans(name, monkeypatch):
    from grape_vector_db_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [])
    ctx = SimpleNamespace(trace=None, calls=[(0, 0.0, 1.0, True)])
    assert bench.load_module("metrics", name).read(ctx) is None

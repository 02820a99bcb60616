"""The comparison that decides ``correct`` must fail what it exists to catch.

The control (the reference computed in fp8, the step below the
configuration's bf16, put in the program's place) has to fail a cell's
limits; and a run whose timed path is broken underneath has to come out
not correct, for each fault a search cell can have: an answer altered where
it is produced, half of the batch left out, part of the corpus left out of
the scan, an acknowledged write lost. The card-size control runs through
``portbench/calibrate.py``; these run the same code on the CPU at the
rehearsal's size.
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import calibrate  # noqa: E402
from portbench.harness import bench, runner  # noqa: E402

CELLS = [w["name"] for w in bench.read_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 912_345_678])
def test_the_control_fails_the_cells_limits(name, seed):
    cell = bench.load_cell(name)
    numbers = calibrate.control_numbers(cell, seed, "cpu", rehearse=True)
    checks, within = runner.judge_limits(numbers, cell.limits)
    assert not within, checks
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"], checks


def alter_one_id(monkeypatch):
    from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex

    orig = FlatDeviceIndex.hits_from_slots

    def hits(self, vals, idxs):
        idxs = np.array(idxs)
        idxs[0, 1] = (idxs[0, 1] + 1) % len(self)
        return orig(self, vals, idxs)

    monkeypatch.setattr(FlatDeviceIndex, "hits_from_slots", hits)


def alter_one_score(monkeypatch):
    from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex

    orig = FlatDeviceIndex.hits_from_slots

    def hits(self, vals, idxs):
        vals = np.array(vals)
        vals[-1, 0] += 1e-3
        return orig(self, vals, idxs)

    monkeypatch.setattr(FlatDeviceIndex, "hits_from_slots", hits)


def half_batch_left_out(monkeypatch):
    """The scan answers the first half of the batch; the second half gets
    the first half's answers."""
    from grape_vector_db_tpu_torch.index.binary import BinaryDeviceIndex
    from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex

    for cls in (FlatDeviceIndex, BinaryDeviceIndex):
        orig = cls.raw_topk

        def raw(self, queries, k, mask=None, _orig=orig):
            h = queries.shape[0] // 2
            v, i = _orig(self, queries[:h], k, mask)
            return np.concatenate([v, v]), np.concatenate([i, i])

        monkeypatch.setattr(cls, "raw_topk", raw)


def rows_left_out(monkeypatch):
    """The scan skips every other stored row."""
    from grape_vector_db_tpu_torch.index.binary import BinaryDeviceIndex
    from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex

    for cls in (FlatDeviceIndex, BinaryDeviceIndex):
        orig = cls.raw_topk

        def raw(self, queries, k, mask=None, _orig=orig):
            half = np.ones(self.capacity, bool)
            half[1::2] = False
            return _orig(self, queries, k, half)

        monkeypatch.setattr(cls, "raw_topk", raw)


def write_lost(monkeypatch):
    """Each ingest batch's last document is acknowledged but not indexed."""
    from grape_vector_db_tpu_torch.index.flat import FlatDeviceIndex

    orig = FlatDeviceIndex.add_batch

    def add(self, ids, vectors):
        return orig(self, list(ids)[:-1], np.asarray(vectors)[:-1])

    monkeypatch.setattr(FlatDeviceIndex, "add_batch", add)


FAULTS = [alter_one_id, alter_one_score, half_batch_left_out, rows_left_out, write_lost]
# a one-query call has no half batch to leave out
CASES = [(name, fault) for name in CELLS for fault in FAULTS
         if fault is not half_batch_left_out or bench.load_cell(name).traffic["batch"] > 1]


@pytest.mark.parametrize("name,fault", CASES, ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_comes_out_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    cell = bench.load_cell(name)
    res = runner.run_cell(cell, seed=321, seconds=0.5, trace=False, rehearse=True)
    assert res["correct"] is False, res["checks"]

"""The port's tracing hooks on the CPU: ``trace_span`` logs its wall time and
annotates the torch.profiler timeline, ``profile_to`` writes a Chrome trace
that holds the spans recorded inside it, and ``setup_logging`` reads
$GRAPE_LOG as the JAX package's does.
"""

import glob
import json
import logging

import pytest
import torch

from grape_vector_db_tpu.utils import tracing as jax_tracing
from grape_vector_db_tpu_torch.utils import tracing


def test_trace_span_logs_and_annotates(caplog):
    with caplog.at_level(logging.DEBUG, logger="grape_vector_db_tpu_torch"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing.trace_span("gvdb.test_span"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "gvdb.test_span" for e in prof.key_averages())
    msgs = [r.getMessage() for r in caplog.records if r.name == "grape_vector_db_tpu_torch"]
    assert any(m.startswith("span gvdb.test_span took ") and m.endswith(" ms") for m in msgs)


def test_trace_span_threshold_and_errors(caplog):
    with caplog.at_level(logging.DEBUG, logger="grape_vector_db_tpu_torch"):
        with tracing.trace_span("gvdb.quiet", log_threshold_ms=1e9):
            pass
        with pytest.raises(ValueError):
            with tracing.trace_span("gvdb.failing"):
                raise ValueError("inside the span")
    msgs = [r.getMessage() for r in caplog.records]
    assert not any("gvdb.quiet" in m for m in msgs)
    assert any("span gvdb.failing took" in m for m in msgs)


def test_profile_to_writes_a_chrome_trace(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="grape_vector_db_tpu_torch"):
        with tracing.profile_to(str(tmp_path / "prof")):
            with tracing.trace_span("gvdb.profiled_batch"):
                torch.randn(64, 32) @ torch.randn(32, 64)
    files = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "gvdb.profiled_batch" in names
    assert any(files[0] in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("level,want", [("error", logging.ERROR), ("warn", logging.WARNING),
                                        ("debug", logging.DEBUG), ("trace", logging.DEBUG),
                                        ("bogus", logging.INFO), (None, logging.INFO)])
def test_setup_logging_reads_grape_log(monkeypatch, level, want):
    if level is None:
        monkeypatch.delenv("GRAPE_LOG", raising=False)
    else:
        monkeypatch.setenv("GRAPE_LOG", level)
    saved = (tracing.logger.level, jax_tracing.logger.level)
    try:
        got = tracing.setup_logging()
        assert got is tracing.logger and got.name == "grape_vector_db_tpu_torch"
        assert got.level == want == jax_tracing.setup_logging().level
        assert tracing.setup_logging("error").level == logging.ERROR
    finally:
        tracing.logger.setLevel(saved[0])
        jax_tracing.logger.setLevel(saved[1])

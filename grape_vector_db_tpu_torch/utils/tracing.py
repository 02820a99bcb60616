"""Tracing / profiling hooks (reference SURVEY.md §5: tracing + QueryTimer ->
'structured host logging + profiler traces hooked at the same points').

- ``setup_logging``: structured host logging (the analog of the reference's
  tracing-subscriber env-filter init, examples/embedded_mode_simple.rs:12-14);
  level from $GRAPE_LOG (error|warn|info|debug|trace).
- ``trace_span``: context manager that both logs span duration and annotates
  the torch.profiler timeline (``record_function``) when a capture is active.
- ``profile_to``: capture a torch.profiler trace around a block (host
  activity, and the card's kernels where CUDA is available) and write it to
  a directory as a Chrome trace, viewable in chrome://tracing or Perfetto.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional


__all__ = ["setup_logging", "trace_span", "profile_to", "logger"]

logger = logging.getLogger("grape_vector_db_tpu_torch")

_LEVELS = {"error": logging.ERROR, "warn": logging.WARNING, "info": logging.INFO,
           "debug": logging.DEBUG, "trace": logging.DEBUG}


def setup_logging(level: Optional[str] = None) -> logging.Logger:
    level = level or os.environ.get("GRAPE_LOG", "info")
    logging.basicConfig(
        format="%(asctime)s %(levelname)-7s %(name)s %(message)s",
        datefmt="%H:%M:%S",
    )
    logger.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    return logger


@contextlib.contextmanager
def trace_span(name: str, log_threshold_ms: float = 0.0) -> Iterator[None]:
    """Annotate the profiler timeline + log the span's wall time."""
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        if ms >= log_threshold_ms:
            logger.debug("span %s took %.2f ms", name, ms)


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace for the enclosed block: host activity,
    plus the card's kernels whenever CUDA is available. The trace is written
    as ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace format)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)

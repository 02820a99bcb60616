"""Tracing / profiling hooks (reference SURVEY.md §5: tracing + QueryTimer ->
'structured host logging + profiler traces hooked at the same points').

- ``setup_logging``: structured host logging (the analog of the reference's
  tracing-subscriber env-filter init, examples/embedded_mode_simple.rs:12-14);
  level from $GRAPE_LOG (error|warn|info|debug|trace).
- ``trace_span``: context manager over one span of the search path. It logs
  the span's wall time at DEBUG, and while a ``torch.profiler`` capture is
  active anywhere in the process it annotates the profiler timeline
  (``record_function``) and records the span. Otherwise it costs a flag
  check and the logger's level check.
- ``profile_to``: capture a torch.profiler trace around a block (host
  activity, and the card's kernels where CUDA is available) and write it to
  a directory as a Chrome trace, viewable in chrome://tracing or Perfetto.

The recorder keeps the spans of the newest capture in a bounded buffer, on
``time.perf_counter_ns``'s clock: name, span id, parent (the innermost span
open on the same thread), call id (the outermost span's id, shared by every
span of one call), thread and both ends. ``spans()`` returns them,
``self_times`` takes the part of each span its host children do not cover,
and ``device_gaps`` sums the device's idle time between the calls' device
windows. A ``DeviceWindow`` brackets a call's device work with a pair of
CUDA events: their elapsed time is an always-on counter, and while
recording they become the call's ``device`` span, tied to the span clock by
an anchor event once per capture. Every
pass of the garbage collector feeds an always-on pause counter by
generation, and while recording becomes a ``gc`` span under whatever span
was open on the thread that ran it.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["setup_logging", "trace_span", "profile_to", "logger", "Span", "DeviceWindow",
           "spans", "dropped", "self_times", "device_gaps", "gc_pause_seconds"]

logger = logging.getLogger("grape_vector_db_tpu_torch")

_LEVELS = {"error": logging.ERROR, "warn": logging.WARNING, "info": logging.INFO,
           "debug": logging.DEBUG, "trace": logging.DEBUG}

MAX_RECORDS = 1 << 18   # records the buffer holds; later ones are counted as dropped
DEVICE = "device"   # the span of a call's device window
GC = "gc"   # the span of a collector pass


def setup_logging(level: Optional[str] = None) -> logging.Logger:
    level = level or os.environ.get("GRAPE_LOG", "info")
    logging.basicConfig(
        format="%(asctime)s %(levelname)-7s %(name)s %(message)s",
        datefmt="%H:%M:%S",
    )
    logger.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    return logger


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: Optional[int]
    call_id: int
    thread_id: int
    t0_ns: int
    t1_ns: int


class _Stack(threading.local):
    def __init__(self) -> None:
        self.open: List["_Span"] = []


class SpanRecorder:
    """The spans of the newest ``torch.profiler`` capture and the collector's
    pause counter. Torch announces each capture's start through
    ``torch.autograd.profiler._run_on_profiler_start``, which the recorder
    wraps: the buffer, its drop count and the device anchors start empty
    there."""

    def __init__(self) -> None:
        self.capacity = MAX_RECORDS
        self.records: List[Span] = []
        self.dropped = 0
        self.anchors: Dict[torch.device, Tuple[torch.cuda.Event, int]] = {}
        self.gc_pause_ns = [0, 0, 0]
        self.ids = itertools.count(1)
        self.stack = _Stack()
        self._mutex = threading.Lock()
        self._gc_t0 = 0
        gc.callbacks.append(self._on_gc)
        start = _profiler._run_on_profiler_start

        def on_start() -> None:
            start()
            self.records, self.dropped, self.anchors = [], 0, {}

        _profiler._run_on_profiler_start = on_start

    def add(self, name: str, t0_ns: int, t1_ns: int) -> None:
        """A span under the innermost one open on this thread."""
        span_id = next(self.ids)
        open_ = self.stack.open
        parent, call = (open_[-1].span_id, open_[-1].call_id) if open_ else (None, span_id)
        self.append(Span(name, span_id, parent, call, threading.get_ident(), t0_ns, t1_ns))

    def append(self, span: Span) -> None:
        if len(self.records) < self.capacity:
            self.records.append(span)
        else:
            with self._mutex:
                self.dropped += 1

    def anchor(self, device: torch.device) -> Tuple[torch.cuda.Event, int]:
        """An event on ``device`` and the span clock's time when it ran: the
        device is synchronised, the event recorded and waited for, and the
        midpoint of the two host reads taken."""
        found = self.anchors.get(device)
        if found is None:
            stream = torch.cuda.current_stream(device)
            torch.cuda.synchronize(device)
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(stream)
            ev.synchronize()
            found = self.anchors[device] = (ev, (t0 + time.perf_counter_ns()) // 2)
        return found

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
            return
        t0, t1 = self._gc_t0, time.perf_counter_ns()
        self.gc_pause_ns[info["generation"]] += t1 - t0
        if _profiler._is_profiler_enabled:
            self.add(GC, t0, t1)


_RECORDER = SpanRecorder()
_annotation = torch._C._profiler._RecordFunctionFast   # on an H100's host: 0.6-1 us, not 7-13


class _Span:
    __slots__ = ("name", "threshold", "record", "rf", "span_id", "call_id", "t0")

    def __init__(self, name: str, threshold: float, record: bool) -> None:
        self.name, self.threshold, self.record = name, threshold, record

    def __enter__(self) -> None:
        if self.record:
            rec = _RECORDER
            self.rf = _annotation(self.name)
            self.rf.__enter__()
            open_ = rec.stack.open
            self.span_id = next(rec.ids)
            self.call_id = open_[-1].call_id if open_ else self.span_id
            open_.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.record:
            rec = _RECORDER
            open_ = rec.stack.open
            open_.pop()
            rec.append(Span(self.name, self.span_id, open_[-1].span_id if open_ else None,
                            self.call_id, threading.get_ident(), self.t0, t1))
            self.rf.__exit__(*exc)
        ms = (t1 - self.t0) / 1e6
        if ms >= self.threshold:
            logger.debug("span %s took %.2f ms", self.name, ms)
        return False


_OFF = contextlib.nullcontext()


def trace_span(name: str, log_threshold_ms: float = 0.0):
    """Annotate the profiler timeline + record the span while a capture is
    active; log the span's wall time at DEBUG."""
    if _profiler._is_profiler_enabled:
        return _Span(name, log_threshold_ms, True)
    if logger.isEnabledFor(logging.DEBUG):
        return _Span(name, log_threshold_ms, False)
    return _OFF


class DeviceWindow:
    """A call's device work between two CUDA events. Two pairs take turns,
    the owner running one call at a time: ``open`` records the start event
    before the call's upload, ``close`` the end event after its last launch,
    and ``settle``, once the readback has synchronised, leaves the pair to
    be counted and, while recording, adds the call's ``device`` span. A
    pair's elapsed time goes into ``ms_total`` at the next call's ``close``,
    while its host would wait for the device anyway, or where ``ms_total``
    is read first."""

    def __init__(self, device: torch.device) -> None:
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.device = torch.device("cuda", index)
        self._pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                       for _ in range(2)]
        self._turn = 0   # the pair of the call in flight
        self._pending: Optional[int] = None   # a finished call's pair, not yet counted
        self._ms = 0.0
        self._mutex = threading.Lock()   # ``ms_total`` is read on other threads
        self._stream: Optional[torch.cuda.Stream] = None   # the device's current stream
        self._raw = 0   # its handle: a cheap check that it is still current
        self._recording = False

    @property
    def ms_total(self) -> float:
        self._count()
        return self._ms

    def open(self) -> None:
        self._recording = _profiler._is_profiler_enabled
        if self._recording:
            _RECORDER.anchor(self.device)
        raw = torch._C._cuda_getCurrentRawStream(self.device.index)
        if raw != self._raw or self._stream is None:
            self._stream, self._raw = torch.cuda.current_stream(self.device), raw
        self._pairs[self._turn][0].record(self._stream)

    def close(self) -> None:
        self._pairs[self._turn][1].record(self._stream)
        self._count()

    def settle(self) -> None:
        start, end = self._pairs[self._turn]
        if self._recording:
            anchor = _RECORDER.anchors.get(self.device)
            if anchor is not None:   # None where a new capture began inside the call
                ev, t_ns = anchor
                _RECORDER.add(DEVICE, t_ns + int(ev.elapsed_time(start) * 1e6),
                              t_ns + int(ev.elapsed_time(end) * 1e6))
        with self._mutex:
            self._pending = self._turn
        self._turn ^= 1

    def _count(self) -> None:
        with self._mutex:
            if self._pending is not None:
                start, end = self._pairs[self._pending]
                self._ms += start.elapsed_time(end)
                self._pending = None


def spans() -> List[Span]:
    """The records of the newest capture, in the order they closed."""
    return list(_RECORDER.records)


def dropped() -> int:
    """Records of the newest capture left out because the buffer was full."""
    return _RECORDER.dropped


def gc_pause_seconds() -> Tuple[float, ...]:
    """Seconds the garbage collector has held the process, by generation."""
    return tuple(ns / 1e9 for ns in _RECORDER.gc_pause_ns)


def _covered(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def self_times(records: List[Span]) -> Dict[int, int]:
    """Span id -> its duration less the part of it that its child spans
    cover, in ns. ``device`` spans lie on the device, not on a host thread,
    and cover nothing."""
    children: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for s in records:
        if s.parent_id is not None and s.name != DEVICE:
            children[s.parent_id].append((s.t0_ns, s.t1_ns))
    return {s.span_id: s.t1_ns - s.t0_ns - _covered(children.get(s.span_id, []),
                                                      s.t0_ns, s.t1_ns)
            for s in records}


def device_gaps(records: Optional[List[Span]] = None, t0_ns: Optional[int] = None,
                t1_ns: Optional[int] = None) -> int:
    """The device's idle ns outside the union of the calls' device windows
    that lie in [t0_ns, t1_ns] (by default from the first window's start to
    the last's end); 0 where no window lies there."""
    records = spans() if records is None else records
    windows = [(s.t0_ns, s.t1_ns) for s in records if s.name == DEVICE
               and (t0_ns is None or s.t0_ns >= t0_ns)
               and (t1_ns is None or s.t1_ns <= t1_ns)]
    if not windows:
        return 0
    lo = min(a for a, _ in windows) if t0_ns is None else t0_ns
    hi = max(b for _, b in windows) if t1_ns is None else t1_ns
    return hi - lo - _covered(windows, lo, hi)


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace for the enclosed block: host activity,
    plus the card's kernels whenever CUDA is available. The trace is written
    as ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)

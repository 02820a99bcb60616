"""Spans the harness records around its calls into each layer, and the
device trace of the traced window.

The traced run (``--trace 1``) wraps the database's entry and the index's
methods in timed wrappers (instance attributes, so the program is not
edited), and runs ``torch.profiler`` with CUDA activity over the whole
window. Host CPU ops are not profiled: four callers' ops would slow the host
path the spans time. One tiny kernel before the window and one after it,
each launched on an idle device, tie the device clock to
``time.perf_counter``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120


def op_name(name: str) -> str:
    """A device op's name without ``void``, the common namespaces and the
    argument list, so that its template arguments stay readable."""
    n = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    n = n.replace("at::native::", "")
    depth = 0
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            n = n[:i]
            break
    return n[:NAME_CHARS]


class Spans:
    """(name, thread, start, end) records on ``time.perf_counter``'s clock."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, int, float, float]] = []

    def wrap(self, fn: Callable, name: str) -> Callable:
        rec = self.records

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec.append((name, threading.get_ident(), t0, time.perf_counter()))

        return timed

    def wrap_method(self, obj, attr: str, name: str) -> None:
        """Time ``obj.attr`` through an instance attribute of ``obj``."""
        setattr(obj, attr, self.wrap(getattr(obj, attr), name))

    def durations(self, name: str, since: float) -> List[float]:
        return [t1 - t0 for n, _, t0, t1 in self.records if n == name and t0 >= since]


@dataclass
class TraceSummary:
    window_s: float                 # device clock, first marker to last
    busy_s: float                   # union of device activity in the window
    device_s: float                 # summed durations of device activity
    n_kernels: int
    ops: List[Tuple[str, float]]    # device seconds by op name, largest first
    idle: List[Tuple[str, float]]   # idle seconds by what the host was in


def device_events(trace: dict) -> List[dict]:
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS]
    evs.sort(key=lambda e: float(e["ts"]))
    return evs


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def host_state(spans: Spans, names_inner_first: List[str]) -> Callable[[float], str]:
    """A function of a host time: the innermost span each thread was in,
    the distinct ones sorted and joined by ``+`` ("caller" where a thread
    was in none)."""
    by_thread: Dict[int, Dict[str, Tuple[List[float], List[float]]]] = defaultdict(dict)
    for name, tid, t0, t1 in sorted(spans.records, key=lambda r: r[2]):
        starts, ends = by_thread[tid].setdefault(name, ([], []))
        starts.append(t0)
        ends.append(t1)

    def inside(starts, ends, t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and ends[i] >= t

    def state(t: float) -> str:
        found = set()
        for per in by_thread.values():
            for name in names_inner_first:
                if name in per and inside(*per[name], t):
                    found.add(name)
                    break
            else:
                found.add("caller")
        return "+".join(sorted(found))

    return state


def summarize(trace: dict, t_mark0: float, spans: Optional[Spans],
              names_inner_first: List[str]) -> Optional[TraceSummary]:
    """Read a Chrome trace whose first and last device events are the
    markers launched at host times ``t_mark0`` (and after the window).
    None where the trace holds no device activity between them."""
    evs = device_events(trace)
    if len(evs) < 3:
        return None
    first, last = evs[0], evs[-1]
    lo = float(first["ts"])
    hi = float(last["ts"]) + float(last.get("dur", 0.0))
    inner = evs[1:-1]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in inner]
    busy = union(iv)
    by_name: Dict[str, float] = defaultdict(float)
    for e in inner:
        by_name[op_name(str(e.get("name", "?")))] += float(e.get("dur", 0.0)) / 1e6
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    idle: Dict[str, float] = defaultdict(float)
    if spans is not None:
        state = host_state(spans, names_inner_first)
        for a, b in gaps:
            idle[state(t_mark0 + ((a + b) / 2 - lo) / 1e6)] += (b - a) / 1e6
    return TraceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        device_s=sum(b - a for a, b in iv) / 1e6,
        n_kernels=sum(1 for e in inner if str(e.get("cat", "")).lower() == "kernel"),
        ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle=sorted(idle.items(), key=lambda kv: -kv[1]))


class DeviceTrace:
    """``torch.profiler`` with CUDA activity over the window, bracketed by
    the two markers."""

    def __init__(self, torch_mod, device) -> None:
        self.torch = torch_mod
        self.device = device
        self.prof = None
        self.t_mark0 = None
        self.trace: Optional[dict] = None

    def _marker(self) -> float:
        torch = self.torch
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        torch.ones(1, device=self.device)
        torch.cuda.synchronize(self.device)
        return t

    def start(self) -> None:
        torch = self.torch
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_mark0 = self._marker()

    def stop(self) -> None:
        self._marker()
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = json.load(f)
        self.prof = None

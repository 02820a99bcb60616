"""Closed loop of batch callers: ``callers`` threads, each issuing its next
``target(batch, k)`` call as soon as its last one returns.

This is how a library user with a thread pool loads the database: the calls
queue for the device behind the index lock while the host work of the
others (hit building, the planner's ``ScoredPoint`` objects) overlaps it.
Call ``j`` (counted over all callers) takes distinct batch ``j % len(batches)``.

Traffic keys: ``callers``, ``k``, ``warmup_calls`` (per caller, before the
window, at the window's own shape), ``check_stride`` (every that many-th call,
from an offset drawn from the seed, keeps its answers for the comparison),
``trace_seconds`` (the traced slice, in the middle of the window).

With a tracer, the callers pause between calls at the slice's two ends
while the tracer starts and stops, so the slice holds whole calls only.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

JOIN_GRACE_S = 120.0


class _Gate:
    """Lets the main thread hold the callers between calls."""

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.paused = False
        self.inflight = 0

    def enter(self) -> None:
        with self.cond:
            while self.paused:
                self.cond.wait()
            self.inflight += 1

    def leave(self) -> None:
        with self.cond:
            self.inflight -= 1
            self.cond.notify_all()

    def hold(self) -> float:
        """Pause the callers, wait out the calls in flight, return the time."""
        with self.cond:
            self.paused = True
            self.cond.wait_for(lambda: self.inflight == 0)
        return time.perf_counter()

    def release(self) -> float:
        t = time.perf_counter()
        with self.cond:
            self.paused = False
            self.cond.notify_all()
        return t


def run(target: Callable, batches: Sequence[np.ndarray], traffic: dict, seconds: float,
        seed: int, tracer=None) -> Dict:
    """Warm up, measure ``seconds``, and return the window: its start and
    deadline on ``time.perf_counter``'s clock, every call as ``(j, issued,
    returned, ok)``, the answers kept for the comparison by call number, the
    first errors, and the traced slice's ends (None without a tracer)."""
    callers, k = int(traffic["callers"]), int(traffic["k"])
    warmup, stride = int(traffic["warmup_calls"]), int(traffic["check_stride"])
    offset = int(np.random.default_rng(seed).integers(stride))
    n_batches = len(batches)
    counter = itertools.count()
    ready = threading.Barrier(callers + 1)
    go = threading.Event()
    gate = _Gate()
    window = {"deadline": None}
    calls: List[List[tuple]] = [[] for _ in range(callers)]
    kept: Dict[int, object] = {}
    errors: List[str] = []

    def caller(c: int) -> None:
        try:
            for n in range(warmup):
                target(batches[(c * warmup + n) % n_batches], k)
        except Exception as e:
            errors.append(f"warm-up: {e!r}")
            ready.abort()
            return
        try:
            ready.wait()
        except threading.BrokenBarrierError:
            return
        go.wait()
        deadline = window["deadline"]
        mine = calls[c]
        while True:
            gate.enter()
            try:
                j = next(counter)
                t0 = time.perf_counter()
                if t0 >= deadline:
                    return
                try:
                    res = target(batches[j % n_batches], k)
                    ok = True
                except Exception as e:  # counted as failed, the loop goes on
                    ok = False
                    if len(errors) < 3:
                        errors.append(f"call {j}: {e!r}")
                t1 = time.perf_counter()
            finally:
                gate.leave()
            mine.append((j, t0, t1, ok))
            if ok and j % stride == offset:
                kept[j] = res

    threads = [threading.Thread(target=caller, args=(c,), name=f"caller{c}", daemon=True)
               for c in range(callers)]
    for t in threads:
        t.start()
    try:
        ready.wait()
    except threading.BrokenBarrierError:
        raise RuntimeError(f"a caller failed in its warm-up: {errors}") from None
    t_start = time.perf_counter()
    window["deadline"] = t_start + seconds
    go.set()
    traced: Optional[tuple] = None
    if tracer is not None:
        length = min(float(traffic.get("trace_seconds", seconds)), seconds)
        time.sleep(max(0.0, (seconds - length) / 2))
        gate.hold()
        tracer.start()
        s0 = gate.release()
        time.sleep(length)
        s1 = gate.hold()
        tracer.stop()
        gate.release()
        traced = (s0, s1)
    for t in threads:
        t.join(timeout=seconds + JOIN_GRACE_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a caller was still in a call {JOIN_GRACE_S} s after the window")
    return {"t_start": t_start, "deadline": window["deadline"],
            "calls": sorted(c for mine in calls for c in mine), "kept": kept,
            "errors": errors, "traced": traced}

"""The program's own spans in the traced slice, for the per-layer metrics
that read them.

The port records its spans itself while a ``torch.profiler`` capture is
active (``grape_vector_db_tpu_torch.utils.tracing``), on
``time.perf_counter_ns``, the clock of the slice's calls. A reader keeps the
spans that lie within the slice's calls and gives a mean per call. Each
returns None where the program recorded no span there, as a program without
the recorder does.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional


def in_slice(ctx) -> Optional[SimpleNamespace]:
    """The recorder's module, the spans between the first call's start and
    the last call's return, those ends in ns, and the count of calls; None
    where there is nothing to read."""
    try:
        from grape_vector_db_tpu_torch.utils import tracing

        spans = tracing.spans
    except (ImportError, AttributeError):
        return None
    calls = [c for c in ctx.calls if c[3]]
    if not calls:
        return None
    lo = int(min(c[1] for c in calls) * 1e9)
    hi = int(max(c[2] for c in calls) * 1e9)
    records = [s for s in spans() if lo <= s.t0_ns and s.t1_ns <= hi]
    if not records:
        return None
    return SimpleNamespace(tracing=tracing, records=records, lo=lo, hi=hi, calls=len(calls))


def mean_ms(ctx, name: str, self_time: bool) -> Optional[float]:
    """Milliseconds per call in the spans named ``name`` (their self time,
    or their whole length); None where the program recorded none."""
    got = in_slice(ctx)
    if got is None:
        return None
    picked = [s for s in got.records if s.name == name]
    if not picked:
        return None
    if self_time:
        own = got.tracing.self_times(got.records)
        total = sum(own[s.span_id] for s in picked)
    else:
        total = sum(s.t1_ns - s.t0_ns for s in picked)
    return total / got.calls / 1e6

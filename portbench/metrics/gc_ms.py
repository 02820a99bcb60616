"""gc_ms: milliseconds the garbage collector held the process, per call of
the traced slice: the program's ``gc`` spans (every pass, on any thread)
within the slice's calls. 0 where the program recorded spans but no pass."""

from portbench.harness.program_spans import in_slice


def read(ctx):
    got = in_slice(ctx)
    if got is None:
        return None
    passes = [s for s in got.records if s.name == got.tracing.GC]
    return sum(s.t1_ns - s.t0_ns for s in passes) / got.calls / 1e6

"""gap_ms: milliseconds per call in which the device sat idle outside the
calls' device windows (each window: the CUDA events before a call's upload
and after its last launch, as the program's ``device`` spans), from the
first call's start to the last call's return in the traced slice
(``device_gaps`` of the program's recorder)."""

from portbench.harness.program_spans import in_slice


def read(ctx):
    got = in_slice(ctx)
    if got is None or not any(s.name == got.tracing.DEVICE for s in got.records):
        return None
    return got.tracing.device_gaps(got.records, got.lo, got.hi) / got.calls / 1e6

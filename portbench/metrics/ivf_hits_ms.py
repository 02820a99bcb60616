"""ivf_hits_ms: host milliseconds an IVF search call spends turning the
read-back cells into sorted, deduplicated ``(id, score)`` hits in
``IvfDeviceIndex.search_batch``'s own loop: the program's ``index.hits``
span, its self time, per call of the traced slice."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.hits", self_time=True)

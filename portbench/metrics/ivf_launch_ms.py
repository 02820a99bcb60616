"""ivf_launch_ms: host milliseconds an IVF search call spends enqueueing its
kernels (the centroid product, the probe and the selection): the program's
``index.launch`` span, its self time, per call of the traced slice."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.launch", self_time=True)

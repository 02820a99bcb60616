"""ivf_readback_ms: milliseconds an IVF search call's host is blocked
reading its results back (the wait for the device, then the copy): the
program's ``index.readback`` span, whole, per call of the traced slice."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.readback", self_time=False)

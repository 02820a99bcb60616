"""readback_wait_ms: milliseconds a call's host is blocked reading its
results back (every ``.cpu()``: the wait for the device to finish, then the
copy): the program's ``index.readback`` span, whole, per call of the traced
slice."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.readback", self_time=False)

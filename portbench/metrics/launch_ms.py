"""launch_ms: host milliseconds a call spends enqueueing its kernels (the
flat scan's ``scored_topk``; the binary prescan and ``_rescore_topk``): the
program's ``index.launch`` span, its self time, per call of the traced
slice. The host's cost of the launches, which the device waits out where
it runs ahead of them."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.launch", self_time=True)

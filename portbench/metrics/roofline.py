"""What every ``<work>_roofline`` reader shares: the least time the
window's calls needed, by ``work/<work>.py`` and the card's peaks, over the
device time the trace gives them (kernels, copies and fills, summed), in
percent. None where the trace or the work has nothing to read."""


def share(ctx, work_name: str):
    t = ctx.trace
    if t is None or t.device_s <= 0:
        return None
    w = ctx.work(work_name)
    if w is None:
        return None
    n_calls = sum(1 for c in ctx.calls if c[3])
    return 100.0 * ctx.least_seconds(*w) * n_calls / t.device_s

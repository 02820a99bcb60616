"""index_ms: host milliseconds a call spends inside the index's
``search_batch`` (padding, the index lock and its wait, the upload, the
device work and ``.cpu()`` readback, ``hits_from_slots``): the mean over the
window's calls."""


def read(ctx):
    if ctx.spans is None:
        return None
    index = ctx.spans.durations("index", ctx.t_start)
    return sum(index) / len(index) * 1e3 if index else None

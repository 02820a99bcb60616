"""kernels_per_call: device kernels launched per search call, from the
trace (copies and fills not counted)."""


def read(ctx):
    t = ctx.trace
    n_calls = sum(1 for c in ctx.calls if c[3])
    if t is None or not n_calls:
        return None
    return t.n_kernels / n_calls

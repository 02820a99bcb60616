"""ivf_probe_ms: device milliseconds per call of the IVF probe kernel (B3,
``csrc/ivf_probe.cu``): the trace's device ops whose name holds
``probe_kernel``, summed over the traced slice, per call."""


def read(ctx):
    t = ctx.trace
    n_calls = sum(1 for c in ctx.calls if c[3])
    if t is None or not n_calls:
        return None
    probe = [s for name, s in t.ops if "probe_kernel" in name]
    return sum(probe) / n_calls * 1e3 if probe else None

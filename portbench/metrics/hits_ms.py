"""hits_ms: host milliseconds a call spends turning the read-back slots into
``(id, score)`` hits (``hits_from_slots``): the program's ``index.hits``
span, its self time (collector passes inside it left out), per call of the
traced slice."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "index.hits", self_time=True)

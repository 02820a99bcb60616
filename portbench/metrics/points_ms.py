"""points_ms: host milliseconds a call spends building the caller's
``ScoredPoint``s in ``QueryEngine.vector_search_batch``: the program's
``planner.points`` span, its self time (collector passes inside it left
out), per call of the traced slice."""

from portbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "planner.points", self_time=True)

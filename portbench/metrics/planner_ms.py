"""planner_ms: host milliseconds a call spends in the API and the planner
(``VectorDatabase.vector_search_batch`` into ``QueryEngine``), outside the
index's ``search_batch``: the mean over the window's calls of the call's
span less its index span."""


def read(ctx):
    if ctx.spans is None:
        return None
    calls = ctx.spans.durations("planner", ctx.t_start)
    index = ctx.spans.durations("index", ctx.t_start)
    if not calls or len(index) != len(calls):
        return None
    return (sum(calls) - sum(index)) / len(calls) * 1e3

"""rank_ms: device milliseconds a batch of the ranking layer
(``models/cf_kan.py``'s ``_top_k``: mask the seen items, sort, keep the top
k), in the benchmark's ``kanbench.rank`` range."""


def read(ctx):
    n = ctx.trace.span_counts.get("kanbench.rank", 0)
    t = ctx.trace.device_s(span="kanbench.rank")
    return 1e3 * t / n if n and t > 0 else None

"""kan_apply_ms: device milliseconds a batch of the KAN registry layer
(``core/kan.py``'s ``apply`` and the backend it dispatches to: bounding,
basis, the kernel, the crossbar passes, the base branch), in the
benchmark's ``kanbench.kan_apply`` range."""


def read(ctx):
    n = ctx.trace.span_counts.get("kanbench.kan_apply", 0)
    t = ctx.trace.device_s(span="kanbench.kan_apply")
    return 1e3 * t / n if n and t > 0 else None

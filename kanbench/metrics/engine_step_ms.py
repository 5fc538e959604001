"""engine_step_ms: device milliseconds a step of the serving engine
(``serve/engine.py``'s ``step``: the prefill chunks of the slots still
consuming their prompts, then one fused decode tick over every slot), in
the benchmark's ``kanbench.engine_step`` range."""


def read(ctx):
    n = ctx.trace.span_counts.get("kanbench.engine_step", 0)
    t = ctx.trace.device_s(span="kanbench.engine_step")
    return 1e3 * t / n if n and t > 0 else None

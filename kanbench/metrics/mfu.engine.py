"""mfu.engine: the engine's share of the card's peak over the traced steps:
the model's FLOPs for the prompt tokens its prefill chunks consumed and the
tokens its decode ticks computed for live slots, plus the unembedding of
every token emitted, over the traced window's seconds times the peak rate
of ``peaks.py``. Counted from the configuration file's widths: per token
and layer the in- and out-projections and the conv (2 FLOPs a weight) and
the SSD recurrence (4 H P N: the state's update and its read-out); norms,
gates and other elementwise work are left out, so the share is a floor."""
from kanbench import peaks


def token_flops(m) -> float:
    """FLOPs of one token through one layer."""
    d, di, n = m["d_model"], m["expand"] * m["d_model"], m["d_state"]
    heads = di // m["head_dim"]
    proj = 2.0 * d * (2 * di + 2 * n + heads) + 2.0 * di * d
    conv = 2.0 * m["conv_width"] * (di + 2 * n)
    return proj + conv + 4.0 * heads * m["head_dim"] * n


def read(ctx):
    m = ctx.model
    prompt = sum(sum(step.get("chunks", ())) for step in ctx.counts)
    decode = sum(step.get("decode", 0) for step in ctx.counts)
    emitted = sum(step.get("tokens", 0) for step in ctx.counts)
    window = ctx.trace.window_s
    if ctx.trace.busy_s() <= 0 or window <= 0 or not prompt + decode:
        return None
    flops = (m["n_layers"] * token_flops(m) * (prompt + decode)
             + 2.0 * m["d_model"] * m["vocab"] * emitted)
    return 100.0 * flops / (window * peaks.FLOPS)

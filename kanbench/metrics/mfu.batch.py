"""mfu.batch: the whole batch's share of the card's peak: the model's FLOPs
over the traced batches, 2 B I (K+1) O for each KAN layer (each input
touches K+1 bases, the B-spline's local support, fixed by the
configuration), over the traced window's seconds times the peak rate of
``peaks.py``."""
from kanbench import peaks


def read(ctx):
    if ctx.trace.busy_s() <= 0:
        return None
    k1 = ctx.model["order"] + 1
    flops = sum(2.0 * c["batch"] * c["in"] * k1 * c["out"]
                for batch in ctx.counts for c in batch)
    window = ctx.trace.window_s
    return 100.0 * flops / (window * peaks.FLOPS) if flops and window > 0 \
        else None

"""kan_fused_roofline: the share of its roofline that ``kan_fused``
(``kernels/csrc/kan_fused.cu``) reaches over the traced batches: the least
time the card could take for its calls' work (``roofline/kan_fused.py``
against ``peaks.py``) over its kernels' device time."""
from kanbench import peaks
from kanbench.roofline import kan_fused

KERNEL = r"kan_fused"


def read(ctx):
    t = ctx.trace.device_s(kernel=KERNEL)
    layers = [c for batch in ctx.counts for c in batch
              if "nonzero_taps" in c]
    if t <= 0 or not layers:
        return None
    bound = sum(peaks.bound_s(*kan_fused.count(
        c["batch"], c["in"], c["basis"], c["out"], c["nonzero_taps"]))
        for c in layers)
    return 100.0 * bound / t

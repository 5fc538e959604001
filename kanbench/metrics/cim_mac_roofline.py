"""cim_mac_roofline: the share of its roofline that ``cim_mac``
(``kernels/csrc/cim_mac.cu``, with the sum of its parts) reaches over the
traced batches: the least time the card could take for its calls' work
(``roofline/cim_mac.py`` against ``peaks.py``) over its kernels' device
time."""
from kanbench import peaks
from kanbench.roofline import cim_mac

KERNEL = r"mac_kernel<\s*\w+\s*,\s*true\s*>|cim_mac_sum_parts"


def read(ctx):
    t = ctx.trace.device_s(kernel=KERNEL)
    layers = [c for batch in ctx.counts for c in batch if "live_pairs" in c]
    if t <= 0 or not layers:
        return None
    a_s = ctx.traffic["hardware"]["array_size"]
    bound = sum(peaks.bound_s(*cim_mac.count(
        c["batch"], c["in"] * c["basis"], c["out"], c["live_pairs"], a_s))
        for c in layers)
    return 100.0 * bound / t

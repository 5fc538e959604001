"""cim_mac_tiled_roofline: the share of its roofline that ``cim_mac_tiled``
(``kernels/csrc/cim_mac_tiled.cu``) reaches over the traced batches: the
least time the card could take for its calls' work
(``roofline/cim_mac_tiled.py`` against ``peaks.py``) over its kernel's
device time."""
from kanbench import peaks
from kanbench.roofline import cim_mac_tiled

KERNEL = r"mac_kernel<\s*\w+\s*,\s*false\s*>"


def read(ctx):
    t = ctx.trace.device_s(kernel=KERNEL)
    layers = [c for batch in ctx.counts for c in batch if "live_pairs" in c]
    if t <= 0 or not layers:
        return None
    hw = ctx.traffic["hardware"]
    bound = sum(peaks.bound_s(*cim_mac_tiled.count(
        c["batch"], c["in"] * c["basis"], c["out"], c["live_pairs"],
        hw["array_size"], hw["variation_sigma"] > 0))
        for c in layers)
    return 100.0 * bound / t

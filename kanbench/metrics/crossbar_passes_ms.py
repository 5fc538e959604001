"""crossbar_passes_ms: device milliseconds a batch of the crossbar and chip
model's own passes (``hw/cim.py``, ``hw/chip.py``, ``hw/tiles.py``: the
word-line DAC, the gather into physical order, the rescale), and the
basis and base branch around them: ``kan_apply_ms`` less the crossbar
kernels' device time (``cim_mac``, ``cim_mac_tiled``)."""

CROSSBAR_KERNELS = r"mac_kernel|cim_mac_sum_parts"


def read(ctx):
    n = ctx.trace.span_counts.get("kanbench.kan_apply", 0)
    kernels = ctx.trace.device_s(span="kanbench.kan_apply",
                                 kernel=CROSSBAR_KERNELS)
    if not n or kernels <= 0:
        return None
    return 1e3 * (ctx.trace.device_s(span="kanbench.kan_apply")
                  - kernels) / n

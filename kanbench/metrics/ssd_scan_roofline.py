"""ssd_scan_roofline: the share of its roofline that ``ssd_scan``
(``kernels/csrc/ssd_scan.cu``: its five kernels, split, scores, state,
pass and scan) reaches over the traced steps: the least time the card
could take for the calls' work (``roofline/ssd_scan.py`` against
``peaks.py``), over those kernels' device time. The engine calls it once a
layer for each prefill chunk, with the slot's carried state after the
first."""
from kanbench import peaks
from kanbench.roofline import ssd_scan

KERNEL = r"ssd_(split|scores|state|pass|scan)_kernel"


def read(ctx):
    t = ctx.trace.device_s(kernel=KERNEL)
    m = ctx.model
    calls = [c for step in ctx.counts for c in step.get("chunks", ())]
    if t <= 0 or not calls:
        return None
    heads = m["expand"] * m["d_model"] // m["head_dim"]
    bound = m["n_layers"] * sum(peaks.bound_s(*ssd_scan.count(
        n, heads, m["head_dim"], m["d_state"])) for n in calls)
    return 100.0 * bound / t

"""wl_dac_ms: device milliseconds a batch of the crossbars'
word-line DAC (``hw/cim.py``'s ``quantize_wl``).
Read from the program's stage spans (``repro_torch.obs.trace``, stage
``xbar.wl_dac``; CUDA events recorded while the profiler runs) for the last
``kan.apply`` calls, as many as the traced window holds."""
from repro_torch.obs import trace as program

STAGE = "xbar.wl_dac"


def read(ctx):
    n = sum(1 for _, _, name in ctx.trace.host if name == "kan.apply")
    records = getattr(program, "stage_records", None)
    if not n or records is None:
        return None
    recs = records(n)
    ms = [r[STAGE] for r in recs if STAGE in r]
    return sum(ms) / len(recs) if ms else None

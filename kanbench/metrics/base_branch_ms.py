"""base_branch_ms: device milliseconds a batch of the KAN layers'
base branch (``act(x) @ w_base``) and its add.
Read from the program's stage spans (``repro_torch.obs.trace``, stage
``kan.base``; CUDA events recorded while the profiler runs) for the last
``kan.apply`` calls, as many as the traced window holds."""
from repro_torch.obs import trace as program

STAGE = "kan.base"


def read(ctx):
    n = sum(1 for _, _, name in ctx.trace.host if name == "kan.apply")
    records = getattr(program, "stage_records", None)
    if not n or records is None:
        return None
    recs = records(n)
    ms = [r[STAGE] for r in recs if STAGE in r]
    return sum(ms) / len(recs) if ms else None

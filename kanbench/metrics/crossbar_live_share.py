"""crossbar_live_share: the share of the crossbar kernels' walk that does
useful work: the live (batch row, word line) pairs a batch, as the plain
reference counts them from the same inputs (``live_pairs``), over the pairs
whose terms the kernels formed (``xbar.rows_iterated``, the kernels' own
device counter, which the program's stage records keep while the profiler
runs: ``repro_torch.obs.trace``)."""
from repro_torch.obs import trace as program


def read(ctx):
    n = sum(1 for _, _, name in ctx.trace.host if name == "kan.apply")
    records = getattr(program, "stage_records", None)
    if not n or records is None or not ctx.counts:
        return None
    recs = records(n)
    iterated = sum(r.get("xbar.rows_iterated", 0) for r in recs)
    live = sum(c["live_pairs"] for batch in ctx.counts for c in batch
               if "live_pairs" in c)
    if iterated <= 0 or not live:
        return None
    return 100.0 * (live / len(ctx.counts)) / (iterated / len(recs))

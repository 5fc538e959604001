"""kan_apply_idle_ms: device idle milliseconds a batch while the host was
inside the program's ``kan.apply``: the traced window's idle gaps (no device
operation running), each counted where its midpoint falls inside a
``kan.apply`` host range (``breakdown.idle_gaps``' rule, with the program's
range in place of the innermost event)."""

APPLY = "kan.apply"


def read(ctx):
    t = ctx.trace
    applies = [(s, e) for s, e, name in t.host if name == APPLY]
    if not applies or not t.ops:
        return None
    gaps, reach = [], t.window[0]
    for op in sorted(t.ops, key=lambda o: o.start):
        if min(op.start, t.window[1]) > reach:
            gaps.append((reach, min(op.start, t.window[1])))
        reach = max(reach, op.end)
    if t.window[1] > reach:
        gaps.append((reach, t.window[1]))
    idle = sum(hi - lo for lo, hi in gaps
               if any(s <= 0.5 * (lo + hi) <= e for s, e in applies))
    return idle / 1e3 / len(applies)

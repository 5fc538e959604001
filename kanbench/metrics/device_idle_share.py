"""device_idle_share: the share of the traced window (first traced batch's
start to the last one's end) in which no operation ran on the device."""


def read(ctx):
    window, busy = ctx.trace.window_s, ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / window) if window > 0 and busy > 0 else None

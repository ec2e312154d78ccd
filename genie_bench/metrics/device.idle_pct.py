"""device.idle_pct: the share of the traced window in which no device
operation (kernel, memcpy, memset) runs."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

"""match.roofline_pct: the least time of the count a request
(`least_work` "match") as a share of the count layer kernels' device time;
nothing where none of them ran."""


def read(ctx):
    seconds = ctx.trace.kernel_seconds(ctx.count_kernels())
    if seconds <= 0 or not ctx.least_work or ctx.requests < 1:
        return None
    return 100.0 * ctx.least_seconds("match") / (seconds / ctx.requests)

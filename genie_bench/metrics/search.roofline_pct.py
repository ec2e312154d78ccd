"""search.roofline_pct: the least time one request's answer needs on the
card (reference/<deployment>.py `least_work` "search", at the peaks of
harness/peaks.py), as a share of the traced window's time a request."""


def read(ctx):
    if not ctx.least_work or ctx.requests < 1:
        return None
    return 100.0 * ctx.least_seconds("search") / (ctx.trace.window_s / ctx.requests)

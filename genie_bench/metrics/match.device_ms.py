"""match.device_ms: device milliseconds a request of the configuration's
count layer kernels (its `count_kernels`), from the trace; nothing where
none of them ran."""


def read(ctx):
    seconds = ctx.trace.kernel_seconds(ctx.count_kernels())
    if seconds <= 0 or ctx.requests < 1:
        return None
    return 1e3 * seconds / ctx.requests

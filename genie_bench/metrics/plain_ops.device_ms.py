"""plain_ops.device_ms: device milliseconds a request of every kernel that
is not one of the program's own CUDA kernels (src/repro_torch/kernels/csrc):
PyTorch's kernels for the c-PQ gate, compaction and final order, the pad
mask, the merge, and the queries' hash.  Copies and fills are not kernels."""


def read(ctx):
    seconds = ctx.trace.kernel_seconds(ctx.own_kernels, inside=False)
    if seconds <= 0 or ctx.requests < 1:
        return None
    return 1e3 * seconds / ctx.requests

"""c-PQ Gate histogram: the CUDA kernel's wrapper and its plain PyTorch
version.

    hist[q, t] = #{ n : counts[q, n] == t },  t in [0, max_count]   int32 [Q, max_count+1]

Replaces the TPU kernel `_cpq_hist_kernel` / `cpq_hist_pallas`
(`src/repro/kernels/cpq_hist.py`); the kernel is `csrc/cpq_hist.cu`, whose
header says what bounds it on an H100 and what the design does about it.
The c-PQ Gate (paper section III-C) needs ZA[t] = #{count >= t}; counts live
in the bounded domain [0, max_count], so ZA is the suffix sum of this
histogram (core/cpq.py).  A count outside the domain -- the -1 of a masked
pad column -- matches no bin.

`cpq_hist` launches the kernel for a CUDA tensor and raises when it cannot;
it takes `cpq_hist_plain` only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.cpq import count_histogram
from repro_torch.kernels import build, common

# The plain PyTorch version of this kernel is `core.cpq.count_histogram`
# (a one-hot compare chunked over bins so its temp stays [Q, N, 8]); bound
# here under the kernel's name so the two stand side by side.
cpq_hist_plain = count_histogram

# a block's histogram lives in shared memory: 227 KB of int32 bins
MAX_BINS = 232448 // 4


def cpq_hist(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """hist int32 [Q, max_count + 1] from counts int32 [Q, N], contiguous."""
    if counts.device.type == "cpu":
        return cpq_hist_plain(counts, max_count)
    device = counts.device
    if device.type != "cuda":
        raise ValueError(f"cpq_hist: no kernel for device {device}")
    common.check_operand("cpq_hist counts", counts, 2, device)
    nbins = int(max_count) + 1
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(
            f"cpq_hist: max_count={max_count} needs {nbins} bins; the kernel "
            f"holds 1..{MAX_BINS} in shared memory"
        )
    q, n = counts.shape
    if q == 0 or n == 0:
        return torch.zeros((q, nbins), dtype=torch.int32, device=device)
    # the kernel writes every bin (and zeroes the output itself where it cuts
    # rows into chunks)
    hist = torch.empty((q, nbins), dtype=torch.int32, device=device)
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.repro_cpq_hist(counts.data_ptr(), hist.data_ptr(),
                                    n, q, nbins, stream)
    common.check_status("cpq_hist", status)
    common.note_launch("cpq_hist")
    return hist

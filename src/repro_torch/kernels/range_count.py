"""RANGE match-count: the CUDA kernel's wrapper and its plain PyTorch version.

    counts[q, n] = sum_d (q_lo[q, d] <= data_vals[n, d] <= q_hi[q, d])   int32 [Q, N]

Replaces the TPU kernel `_range_count_kernel` / `range_count_pallas`
(`src/repro/kernels/range_count.py`), whose wrapper pads the queries with the
empty range lo = 1, hi = 0.  The kernel is `csrc/range_count.cu`, a tile of
its own that tests the intervals on the float16 pipe where a chunk of data
values lies in [-2048, 2048] and as int32 elsewhere, and stores whole 16-byte
runs of counts (its header says why and what bounds it).  It masks its ragged
edges, so nothing is padded, and takes lo and hi as they are: nothing is
copied on the host.

`range_count` launches the kernel for CUDA tensors and raises when it cannot;
it takes `range_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_range
from repro_torch.kernels import build, common

# The plain PyTorch version of this kernel is the engine's reference
# semantics, `core.match.match_range`, bound here under the kernel's name so
# the two stand side by side.
range_count_plain = match_range


def range_count(data_vals: torch.Tensor, q_lo: torch.Tensor,
                q_hi: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from tuples int32 [N, d] and intervals q_lo, q_hi
    int32 [Q, d], all contiguous and on one device."""
    if all(t.device.type == "cpu" for t in (data_vals, q_lo, q_hi)):
        return range_count_plain(data_vals, q_lo, q_hi)
    n, q, d = common.check_pair("range_count", data_vals, q_lo)
    common.check_operand("range_count q_hi", q_hi, 2, data_vals.device)
    if q_hi.shape != q_lo.shape:
        raise ValueError(f"range_count: q_lo {tuple(q_lo.shape)} and q_hi "
                         f"{tuple(q_hi.shape)} differ in shape")
    out = torch.empty((q, n), dtype=torch.int32, device=data_vals.device)
    if q == 0 or n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(data_vals.device):
        stream = torch.cuda.current_stream(data_vals.device).cuda_stream
        status = lib.repro_range_count(data_vals.data_ptr(), q_lo.data_ptr(), q_hi.data_ptr(),
                                       out.data_ptr(), n, q, d, stream)
    common.check_status("range_count", status)
    common.note_launch("range_count")
    return out

"""RANGE match-count: the CUDA kernel's wrapper and its plain PyTorch version.

    counts[q, n] = sum_d (q_lo[q, d] <= data_vals[n, d] <= q_hi[q, d])   int32 [Q, N]

Replaces the TPU kernel `_range_count_kernel` / `range_count_pallas`
(`src/repro/kernels/range_count.py`), whose wrapper pads the queries with the
empty range lo = 1, hi = 0.  The kernel is `csrc/range_count.cu`: the count
tile of `csrc/eq_tile.cuh` with an (lo, hi) pair per query slot against one
value per data slot; it masks its ragged edges, so nothing is padded.  It
takes lo and hi as one int32 [Q, d, 2] operand, which the wrapper stacks
(Q * d * 2 ints, nothing beside the [Q, N] count write).

`range_count` launches the kernel for CUDA tensors and raises when it cannot;
it takes `range_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_range
from repro_torch.kernels import common

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
    lohi = torch.stack([q_lo, q_hi], dim=-1)           # [Q, d, 2], contiguous
    return common.launch_count("range_count", data_vals, lohi, n, q, d)

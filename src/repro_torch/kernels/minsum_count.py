"""MINSUM match-count: the CUDA kernel's wrapper and its plain PyTorch version.

    counts[q, n] = sum_v min(data_cnt[n, v], query_cnt[q, v])     int32 [Q, N]

Replaces the TPU kernel `_minsum_kernel` / `minsum_count_pallas`
(`src/repro/kernels/minsum_count.py`), which streams the vocabulary axis V
through a third, accumulating grid axis.  The kernel is
`csrc/minsum_count.cu`: the count tile of `csrc/eq_tile.cuh` already streams
the row axis through shared memory, so MINSUM is that tile with a slot pair
counted by its minimum; the header says what bounds it on an H100.

`minsum_count` launches the kernel for CUDA tensors and raises when it
cannot; it takes `minsum_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_minsum
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is the engine's reference
# semantics, `core.match.match_minsum`, bound here under the kernel's name so
# the two stand side by side.
minsum_count_plain = match_minsum


def minsum_count(data_cnt: torch.Tensor, query_cnt: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from count vectors int32 [N, V] and [Q, V], both
    contiguous and on one device."""
    if data_cnt.device.type == "cpu" and query_cnt.device.type == "cpu":
        return minsum_count_plain(data_cnt, query_cnt)
    n, q, m = common.check_pair("minsum_count", data_cnt, query_cnt)
    return common.launch_count("minsum_count", data_cnt, query_cnt, n, q, m)

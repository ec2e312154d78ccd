"""COSINE match-count: the CUDA kernel's wrapper and its plain PyTorch version.

    counts[q, n] = (V + sum_v query_sgn[q, v] * data_sgn[n, v]) // 2     int32 [Q, N]

Replaces the TPU kernel `_cosine_kernel` / `cosine_count_pallas`
(`src/repro/kernels/cosine_count.py`); the kernel is `csrc/cosine_count.cu`,
whose header says what bounds it on an H100 and what the design does about
it.  The sign agreement of simhash bits is the shifted +-1 inner product; the
kernel takes it over the int8 signs as they are stored (on the int8 tensor
cores, wgmma s8 x s8 -> s32, exact; the tile of `csrc/s8_mma_tile.cuh` that it
shares with `ip_count`), where the TPU wrapper cast them to bf16 for the MXU.

`cosine_count` launches the kernel for CUDA tensors and raises when it
cannot; it takes `cosine_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_cosine
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is `core.match.match_cosine` (the
# engine's reference semantics, chunked so its temp stays [Q, N, chunk]); it
# is bound here under the kernel's name so the two stand side by side.
cosine_count_plain = match_cosine


def cosine_count(data_sgn: torch.Tensor, query_sgn: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from signs int8 [N, V] and [Q, V] in {-1, 0, +1},
    both contiguous and on one device."""
    if data_sgn.device.type == "cpu" and query_sgn.device.type == "cpu":
        return cosine_count_plain(data_sgn, query_sgn)
    n, q, v = common.check_pair("cosine_count", data_sgn, query_sgn, torch.int8)
    return common.launch_count("cosine_count", data_sgn, query_sgn, n, q, v)

"""IP match-count (binary inner product): the CUDA kernel's wrapper and its
plain PyTorch version.

    counts[q, n] = sum_v query_bin[q, v] * data_bin[n, v]        int32 [Q, N]

Replaces the TPU kernel `_ip_kernel` / `ip_count_pallas`
(`src/repro/kernels/ip_count.py`), a bf16 MXU product per V tile added into an
int32 accumulator across a third grid axis.  The kernel is `csrc/ip_count.cu`:
the int8 tensor-core tile of `csrc/s8_mma_tile.cuh` (wgmma s8 x s8 -> s32),
shared with `cosine_count`, with the dot itself as its epilogue; its header
says what bounds it on an H100 and which loader (TMA or registers) a row
width takes (`common.dot_tile_loader`).
The kernel takes int8 {0, 1} word vectors, as `sa.document.binary_vectors`
makes them.

`ip_count` launches the kernel for CUDA tensors and raises when it cannot; it
takes `ip_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_ip
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is the engine's reference
# semantics, `core.match.match_ip` (exact at any V), bound here under the
# kernel's name so the two stand side by side.
ip_count_plain = match_ip


def ip_count(data_bin: torch.Tensor, query_bin: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from word vectors int8 [N, V] and [Q, V], both
    contiguous and on one device."""
    if data_bin.device.type == "cpu" and query_bin.device.type == "cpu":
        return ip_count_plain(data_bin, query_bin)
    n, q, v = common.check_pair("ip_count", data_bin, query_bin, torch.int8)
    return common.launch_count("ip_count", data_bin, query_bin, n, q, v)

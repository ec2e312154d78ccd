"""TANIMOTO match-count (minhash sketch collisions): the CUDA kernel's wrapper
and its plain PyTorch version.

    counts[q, n] = sum_i (data_sigs[n, i] == query_sigs[q, i])     int32 [Q, N]

Replaces the TPU kernel `_tanimoto_kernel` / `tanimoto_count_pallas`
(`src/repro/kernels/tanimoto_count.py`), which streams the signature axis m
through a third grid axis because FLASH-scale sketches do not fit VMEM.  The
kernel is `csrc/tanimoto_count.cu`: the equality tile of `csrc/eq_tile.cuh`
(the EQ kernel's) already streams m through shared memory, so it serves any
m.  Minhash bucket ids lie in [0, n_buckets), below 31744, so every chunk is
compared as float16 lanes, two columns per HSET2, exact because those int16
bit patterns are distinct finite float16 values; the lanes are added into
int32 every 4096 columns, so FLASH-scale m stays exact.  Ids outside that
range take the tile's general int32 path in the same launch.

`tanimoto_count` launches the kernel for CUDA tensors and raises when it
cannot; it takes `tanimoto_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_tanimoto
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is the engine's reference
# semantics, `core.match.match_tanimoto`, bound here under the kernel's name
# so the two stand side by side.
tanimoto_count_plain = match_tanimoto


def tanimoto_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from data int32 [N, m] and queries int32 [Q, m],
    both contiguous and on one device."""
    if data_sigs.device.type == "cpu" and query_sigs.device.type == "cpu":
        return tanimoto_count_plain(data_sigs, query_sigs)
    n, q, m = common.check_pair("tanimoto_count", data_sigs, query_sigs)
    return common.launch_count("tanimoto_count", data_sigs, query_sigs, n, q, m)

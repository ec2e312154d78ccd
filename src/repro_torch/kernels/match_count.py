"""EQ match-count: the CUDA kernel's wrapper and its plain PyTorch version.

    counts[q, n] = sum_i (data_sigs[n, i] == query_sigs[q, i])     int32 [Q, N]

Replaces the TPU kernel `_match_count_kernel` / `match_count_pallas`
(`src/repro/kernels/match_count.py`); the kernel is `csrc/match_count.cu` on
the equality tile of `csrc/eq_tile.cuh`.  GENIE's inverted-index scan,
re-expressed as a dense all-pairs compare: instead of walking postings lists
with atomic counter updates, a block owns a [128, 128] tile of the count
matrix and streams the signature axis through shared memory.

What bounds it on an H100 is the instruction pipes.  A 32-column chunk whose
ids all lie in [0, 31744) -- every bucket id an LSH scheme produces -- is
compared as float16 lanes, two columns per HSET2: those int16 bit patterns are
31,744 distinct finite float16 values with a single zero, so the float16
compare is exact there, and float16 counts are exact up to 2048, so the lanes
are added into int32 every 4096 columns.  Any other chunk takes the tile's
general int32 path in the same launch.  The result is exact int32 for any
int32 input; the kernel picks the path per chunk, with no read-back.

`match_count` launches the kernel for CUDA tensors and raises when it cannot;
it takes `match_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_eq
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is `core.match.match_eq` (the
# engine's reference semantics, chunked so its temp stays [Q, N, chunk]); it
# is bound here under the kernel's name so the two stand side by side.
match_count_plain = match_eq


def match_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from data int32 [N, m] and queries int32 [Q, m],
    both contiguous and on one device."""
    if data_sigs.device.type == "cpu" and query_sigs.device.type == "cpu":
        return match_count_plain(data_sigs, query_sigs)
    n, q, m = common.check_pair("match_count", data_sigs, query_sigs)
    return common.launch_count("match_count", data_sigs, query_sigs, n, q, m)


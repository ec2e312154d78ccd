"""Public entries of the kernel layer: what the GENIE engines call.

The counterpart of `repro/kernels/ops.py`, with the EQ and c-PQ histogram
entries only (the other nine kernels are still to be ported).  The TPU
wrappers pad inputs to tile multiples with sentinels and slice the result
back; the CUDA kernels mask their ragged edges themselves, so an entry here
only brings its operands to the form the kernel takes (int32, contiguous --
the same `astype(int32)` the reference applies) and calls the wrapper.
`repro_torch.kernels.ref` holds the oracles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cpq_hist as _cpq_hist
from repro_torch.kernels import match_count as _mc


def _int32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def match_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor) -> torch.Tensor:
    """EQ engine kernel: counts int32 [Q, N]."""
    return _mc.match_count(_int32(data_sigs), _int32(query_sigs))


def cpq_hist(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """c-PQ Gate histogram: int32 [Q, max_count + 1]."""
    return _cpq_hist.cpq_hist(_int32(counts), max_count)

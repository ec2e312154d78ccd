"""Shared utilities of the CUDA kernel wrappers.

Ported from `repro/kernels/common.py` only as far as the port uses it: the
kernels mask their ragged edges themselves, so `pad_to` / `pick_tile` and the
8/128 TPU alignment floors have no counterpart.  What the wrappers do share
is the launch count: each wrapper calls `note_launch` where it launches its
kernel and nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

_LAUNCHES: dict[str, int] = {}


def note_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset (a copy)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def check_operand(name: str, x: torch.Tensor, ndim: int,
                  device: torch.device, dtype: torch.dtype = torch.int32) -> None:
    """What every kernel takes: a contiguous CUDA tensor of the given rank
    and dtype (int32 unless said otherwise) on `device`.  Raises on anything
    else -- the kernels read raw pointers."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {ndim} dims")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous (strides {x.stride()})")


def check_status(name: str, status: int) -> None:
    """Raise when a launch was refused (the C entry returns
    cudaGetLastError(); a refused launch never runs and a later
    synchronize() would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")

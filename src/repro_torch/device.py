"""The device rule of the port (no counterpart in the JAX package, where
placement is the default backend's)."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]
# elements a block of `int64_sum`: its int64 copy stays at 2 GiB
SUM_BLOCK = 1 << 28


def resolve_device(device: DeviceLike) -> torch.device:
    """`None` means the card.  A CUDA device that is not there raises: the
    port never carries on on the CPU unless the caller asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev


def tensor_from(x) -> torch.Tensor:
    """A tensor as it is; anything else array-like as a CPU tensor sharing the
    array's memory (a read-only array is copied first: PyTorch has no
    read-only tensors)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def synchronize(device: torch.device) -> None:
    """Wait for the device, so that a host timer reads the work and not its
    enqueueing (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def int64_sum(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """The int64 sum of a tensor of whole numbers over its rows (`dim=0`) or
    over every entry (`dim=None`), a block of rows at a time: an int64 sum of
    a narrower tensor widens the whole of it first, 8 bytes an entry (28 GB
    for a 3.5 GB int8 segment)."""
    rows = max(1, SUM_BLOCK // max(1, x[0].numel())) if len(x) else 1
    return sum(b.to(torch.int64).sum(dim=dim) for b in x.split(rows))

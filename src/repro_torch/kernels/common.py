"""Shared utilities of the CUDA kernel wrappers.

Ported from `repro/kernels/common.py` only as far as the port uses it: the
kernels mask their ragged edges themselves, so `pad_to` / `pick_tile` and the
8/128 TPU alignment floors have no counterpart.  What the wrappers do share:

  - the launch count: each wrapper calls `note_launch` where it launches its
    kernel and nowhere else, so a run can show that it went through the
    kernels;
  - the launch of a count kernel with the C entry
    `repro_<name>(data, query, out, n, q, width, stream)`: `check_pair`
    checks its two operands and `launch_count` launches it (match_count,
    tanimoto_count, minsum_count, range_count on the tile of
    `csrc/eq_tile.cuh`; cosine_count, ip_count on the int8 tensor-core tile
    of `csrc/s8_mma_tile.cuh`, whose loader `dot_tile_loader` reports); and
    `launch_fused_topk` with its plain selection `local_topk_plain` for the
    fused match -> count -> per-tile top-k kernels of `csrc/fused_topk.cuh`
    (packed_cosine_topk, packed_tanimoto_topk).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

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


def check_pair(name: str, data: torch.Tensor, query: torch.Tensor,
               dtype: torch.dtype = torch.int32) -> tuple[int, int, int]:
    """Check the data [N, width] and query [Q, width] operands of a count
    kernel (contiguous CUDA tensors of `dtype` on one device); return
    (N, Q, width)."""
    device = data.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    check_operand(f"{name} data", data, 2, device, dtype)
    check_operand(f"{name} query", query, 2, device, dtype)
    n, width = data.shape
    if query.shape[1] != width:
        raise ValueError(
            f"{name}: row widths differ, data {width} vs queries {query.shape[1]}")
    return n, query.shape[0], width


def launch_count(name: str, data: torch.Tensor, query: torch.Tensor,
                 n: int, q: int, width: int, entry: str | None = None) -> torch.Tensor:
    """Allocate counts int32 [q, n] and launch the count kernel through its C
    entry `repro_<entry>(data, query, out, n, q, width, stream)` (entry =
    name unless given) on checked operands; each kernel keeps its own name
    and launch count."""
    device = data.device
    out = torch.empty((q, n), dtype=torch.int32, device=device)
    if q == 0 or n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, f"repro_{entry or name}")(
            data.data_ptr(), query.data_ptr(), out.data_ptr(), n, q, width, stream)
    check_status(name, status)
    note_launch(name)
    return out


def dot_tile_loader(name: str, data: torch.Tensor, query: torch.Tensor) -> str:
    """Which loader of `csrc/s8_mma_tile.cuh` the count kernel `name`
    (cosine_count or ip_count) takes for these checked operands: "tma" when
    the row width is a multiple of 16 and both base pointers are 16-byte
    aligned, else "registers".  The C entry `repro_<name>_loader` answers, by
    the rule its launch uses."""
    check_pair(name, data, query, torch.int8)
    tma = getattr(build.load(), f"repro_{name}_loader")(
        data.data_ptr(), query.data_ptr(), data.shape[1])
    return "tma" if tma else "registers"


def launch_fused_topk(name: str, data: torch.Tensor, query: torch.Tensor,
                      device: torch.device, n: int, q: int, width: int, k: int,
                      tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the candidate buffers of a fused match -> count -> top-k
    kernel and launch it through its two C entries, `repro_<name>_plan` (grid
    and histogram scratch for this width) and `repro_<name>`.  Shared by
    packed_cosine_topk and packed_tanimoto_topk, which take checked
    operands; `width` is the row width the kernel reads (words or bytes)."""
    kc = min(int(k), tile_n)
    slots = -(-n // tile_n) * kc
    ids = torch.empty((q, slots), dtype=torch.int32, device=device)
    cnts = torch.empty((q, slots), dtype=torch.int32, device=device)
    if q == 0 or n == 0:
        return ids, cnts
    lib = build.load()
    with torch.cuda.device(device):
        grid, scratch_ints = ctypes.c_int(), ctypes.c_longlong()
        status = getattr(lib, f"repro_{name}_plan")(
            n, q, width, ctypes.byref(grid), ctypes.byref(scratch_ints))
        check_status(f"{name} (plan)", status)
        # histogram bins that do not fit in shared memory
        scratch = (torch.empty(scratch_ints.value, dtype=torch.int32, device=device)
                   if scratch_ints.value else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, f"repro_{name}")(
            data.data_ptr(), query.data_ptr(), ids.data_ptr(), cnts.data_ptr(),
            n, q, width, kc, grid.value,
            None if scratch is None else scratch.data_ptr(), stream)
    check_status(name, status)
    note_launch(name)
    return ids, cnts


def local_topk_plain(counts: torch.Tensor, k: int,
                     tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-tile selection of the fused kernels (`csrc/fused_topk.cuh`)
    done the plain way, on a full count matrix [Q, N]: cut into tiles of
    `tile_n` ids (the last one filled with count -1), each tile ordered by a
    stable descending sort of its counts (ids ascending within equal counts)
    and cut to its first kc = min(k, tile_n) entries; a slot whose count is
    -1 becomes id -1.  Replaces `local_topk_tile`
    (`src/repro/kernels/packed_cosine.py`)."""
    q, n = counts.shape
    kc = min(int(k), int(tile_n))
    n_tiles = -(-n // tile_n)
    pad = n_tiles * tile_n - n
    if pad:
        counts = torch.cat([counts, counts.new_full((q, pad), -1)], dim=1)
    vals, idx = torch.sort(counts.reshape(q, n_tiles, tile_n), dim=-1,
                           descending=True, stable=True)
    del counts
    vals, idx = vals[..., :kc], idx[..., :kc]
    first = torch.arange(n_tiles, dtype=torch.int64, device=idx.device)[None, :, None] * tile_n
    ids = torch.where(vals >= 0, idx + first, -1).to(torch.int32)
    cnts = torch.where(vals >= 0, vals, -1).to(torch.int32)
    return ids.reshape(q, n_tiles * kc), cnts.reshape(q, n_tiles * kc)

"""Shared utilities of the CUDA kernel wrappers.

Ported from `repro/kernels/common.py` only as far as the port uses it: the
kernels mask their ragged edges themselves, so `pad_to` has no counterpart.
What the wrappers do share:

  - the tile knobs: `pick_variant`, the counterpart of `pick_tile`, maps a
    knob's value (tile_q / tile_n / tile_v / tile_m, validated against the
    reference's alignment floors, TILE_ALIGN) to one of the block shapes a
    kernel was compiled in -- a kernel with one shape maps every value to it;
  - the launch count: each wrapper calls `note_launch` where it launches its
    kernel and nowhere else, so a run can show that it went through the
    kernels (a kernel of several shapes also counts the shape it launched,
    in `variant_launch_counts`); the counts are the process counters
    "kernel.launches" and "kernel.variant_launches" of `repro_torch.trace`;
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

from repro_torch import trace
from repro_torch.kernels import build

_LAUNCHES: dict[str, int] = trace.counter("kernel.launches")
_VARIANT_LAUNCHES: dict[str, int] = trace.counter("kernel.variant_launches")

# Tile-knob alignment floors, the reference's (`repro/core/engines.py`
# TILE_ALIGN, which its `pick_tile` enforces): tile_q a sublane dim (8),
# tile_n / tile_v / tile_m lane dims (128).  A tuned value below its floor is
# refused here as it is there, whatever shape it would select.
TILE_ALIGN: dict[str, int] = {
    "tile_q": 8,
    "tile_n": 128,
    "tile_v": 128,
    "tile_m": 128,
}


def pick_variant(size: int, preferred: int, variants, knob: str = "tile",
                 align: int | None = None) -> int:
    """The block shape a kernel takes for one knob: of its compiled
    `variants`, the smallest that covers `size` when the dim is smaller than
    `preferred` (as `pick_tile` clamps its tile to the whole dim), else the
    largest that is <= `preferred`, else the smallest.  Only variants <=
    `preferred` are ever taken when one exists.

    `preferred` may come from a tuned plan (core/autotune.py), so a bad value
    fails loudly with the caller's knob name, with the reference's checks:
    the alignment (TILE_ALIGN[knob] unless given) must be positive and
    `preferred` must reach it."""
    align = int(TILE_ALIGN.get(knob, 1) if align is None else align)
    preferred = int(preferred)
    if align <= 0:
        raise ValueError(
            f"{knob}: tile alignment must be > 0, got align={align}"
        )
    if preferred < align:
        raise ValueError(
            f"{knob}={preferred} is below the alignment floor {align}: a "
            f"sub-aligned tile would emit a degenerate grid; tuned tiles "
            f"must be multiples of the min-tile width (>= {align})"
        )
    shapes = sorted(int(v) for v in variants)
    fits = [v for v in shapes if v <= preferred] or shapes[:1]
    if size < preferred:
        covering = [v for v in fits if v >= size]
        if covering:
            return covering[0]
    return fits[-1]


def pick_variants(variants: dict, sizes: dict, tiles: dict) -> dict[str, int]:
    """knob -> block shape for every knob of a kernel (`variants`: knob ->
    its compiled shapes; `sizes`: knob -> the dim it tiles): the caller's
    value where it gave one, else the default, the largest shape (or the
    knob's floor, if that is larger)."""
    return {knob: pick_variant(sizes[knob], tiles.get(knob) or max(max(vs), TILE_ALIGN[knob]),
                               vs, knob)
            for knob, vs in variants.items()}


def note_launch(name: str, variant: str | None = None) -> None:
    """Count one launch of kernel `name`; `variant` (e.g. "tile_q=32", the
    block shape launched) also counts it in `variant_launch_counts()` under
    "name[variant]"."""
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
    if variant is not None:
        key = f"{name}[{variant}]"
        _VARIANT_LAUNCHES[key] = _VARIANT_LAUNCHES.get(key, 0) + 1


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset (a copy)."""
    return dict(_LAUNCHES)


def variant_launch_counts() -> dict[str, int]:
    """"kernel[knob=shape]" -> launches in that block shape since the last
    reset (a copy), for the kernels compiled in several shapes."""
    return dict(_VARIANT_LAUNCHES)


def launches_during(fn):
    """(fn(), kernel name -> launches it made): the counts' difference around
    the call, so nothing is reset."""
    before = launch_counts()
    out = fn()
    after = launch_counts()
    return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    _VARIANT_LAUNCHES.clear()


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
                 n: int, q: int, width: int, entry: str | None = None,
                 variant: str | None = None) -> torch.Tensor:
    """Allocate counts int32 [q, n] and launch the count kernel through its C
    entry `repro_<entry>(data, query, out, n, q, width, stream)` (entry =
    name unless given) on checked operands; each kernel keeps its own name
    and launch count, and `variant` names the block shape launched."""
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
    note_launch(name, variant)
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
                      tile_n: int, entry: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the candidate buffers of a fused match -> count -> top-k
    kernel and launch it through its two C entries, `repro_<entry>_plan`
    (grid and histogram scratch for this width) and `repro_<entry>` (entry =
    name unless given: the entry of the shape whose tiles are `tile_n` data
    rows).  Shared by packed_cosine_topk and packed_tanimoto_topk, which take
    checked operands; `width` is the row width the kernel reads (words or
    bytes)."""
    entry = entry or name
    kc = min(int(k), tile_n)
    slots = -(-n // tile_n) * kc
    ids = torch.empty((q, slots), dtype=torch.int32, device=device)
    cnts = torch.empty((q, slots), dtype=torch.int32, device=device)
    if q == 0 or n == 0:
        return ids, cnts
    lib = build.load()
    with torch.cuda.device(device):
        grid, scratch_ints = ctypes.c_int(), ctypes.c_longlong()
        status = getattr(lib, f"repro_{entry}_plan")(
            n, q, width, ctypes.byref(grid), ctypes.byref(scratch_ints))
        check_status(f"{name} (plan)", status)
        # histogram bins that do not fit in shared memory
        scratch = (torch.empty(scratch_ints.value, dtype=torch.int32, device=device)
                   if scratch_ints.value else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, f"repro_{entry}")(
            data.data_ptr(), query.data_ptr(), ids.data_ptr(), cnts.data_ptr(),
            n, q, width, kc, grid.value,
            None if scratch is None else scratch.data_ptr(), stream)
    check_status(name, status)
    note_launch(name, f"tile_n={tile_n}")
    return ids, cnts


# The shared memory a block of the fused kernel (csrc/fused_topk.cuh, Fused)
# asks for: its constants, and the most a block may have (MAX_SMEM).
FUSED_THREADS, FUSED_RQ, FUSED_RN, FUSED_KW, FUSED_MAX_SMEM = 512, 8, 4, 16, 232448


def fused_topk_smem(count_bytes: int, tq: int, tile_n: int, nbins: int) -> int:
    """Dynamic shared memory of the fused kernel's shape Fused<count type of
    `count_bytes`, tq, 16, tile_n> for rows of `nbins` bins, as its launcher
    asks for it (Fused::smem): the count tile, the staging area, and the rows'
    bins where they fit beside them (else they go to device scratch)."""
    sn = FUSED_THREADS // (tq // FUSED_RQ) * FUSED_RN
    fixed = tq * tile_n * count_bytes + (sn * (FUSED_KW + 1) + tq * FUSED_KW) * 4
    bins = tq * nbins * 4
    return fixed + (bins if fixed + bins <= FUSED_MAX_SMEM else 0)


# The equality tile's (csrc/eq_tile.cuh, count_eq_tile) static shared memory:
# the staged chunk of its query and data rows, 33 int32 slots a row.
EQ_TILE_N, EQ_TILE_LDI = 128, 33


def eq_tile_smem(tile_q: int) -> int:
    """Static shared memory of the equality tile with `tile_q` query rows a
    block (Narrow 32, Wide 128) and 128 data rows."""
    return (tile_q + EQ_TILE_N) * EQ_TILE_LDI * 4


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

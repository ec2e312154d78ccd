"""c-PQ compaction: the CUDA kernel's wrapper and its plain PyTorch version.

    ids, vals int32 [Q, cap]: per query row, the entries with count > threshold
    (strict) in id order, then those with count == threshold (ties) in id
    order from slot n_strict, cut at cap; empty slots -1 / -1

The kernel is `csrc/cpq_compact.cu`, whose header says what bounds it on an
H100 and what the design does about it.  It replaces no TPU kernel: the JAX
package writes this step in jnp (`repro.core.cpq._compact_candidates`), and
so does the port's plain version, `core.cpq._compact_candidates`, bound here
as `cpq_compact_plain`: the CPU path and the oracle.

`cpq_compact` launches the kernel for a CUDA tensor and raises when it
cannot; it takes `cpq_compact_plain` only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cpq import _compact_candidates
from repro_torch.kernels import build, common

cpq_compact_plain = _compact_candidates

# one block a row holds its first cap ties in shared memory up to this cap,
# beyond it in a [Q, cap] int32 scratch (csrc/cpq_compact.cu, SMEM_TIES)
SMEM_TIES = 8192


def compact_plan(n: int, q: int, cap: int) -> tuple[int, int]:
    """(n_chunks, scratch_ints) of the kernel's cut for counts [q, n] into
    cap slots on the current device: n_chunks 1 where one block owns a row,
    else the chunks a row is cut into; scratch_ints the int32 scratch the
    launch takes."""
    n_chunks, scratch_ints = ctypes.c_int(), ctypes.c_longlong()
    status = build.load().repro_cpq_compact_plan(
        n, q, cap, ctypes.byref(n_chunks), ctypes.byref(scratch_ints))
    common.check_status("cpq_compact (plan)", status)
    return n_chunks.value, scratch_ints.value


def cpq_compact(counts: torch.Tensor, threshold: torch.Tensor,
                cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, vals) int32 [Q, cap] from counts [Q, N] and threshold [Q]
    (cast to int32, as the plain version casts; no copy for contiguous
    int32 operands)."""
    if counts.device.type == "cpu":
        return cpq_compact_plain(counts, threshold, cap)
    device = counts.device
    if device.type != "cuda":
        raise ValueError(f"cpq_compact: no kernel for device {device}")
    counts = counts.to(torch.int32).contiguous()
    threshold = threshold.to(torch.int32).contiguous()
    common.check_operand("cpq_compact counts", counts, 2, device)
    common.check_operand("cpq_compact threshold", threshold, 1, device)
    q, n = counts.shape
    if threshold.shape[0] != q:
        raise ValueError(f"cpq_compact: {threshold.shape[0]} thresholds for {q} query rows")
    cap = int(cap)
    ids = torch.empty((q, cap), dtype=torch.int32, device=device)
    vals = torch.empty((q, cap), dtype=torch.int32, device=device)
    if q == 0 or cap == 0:
        return ids, vals
    if n == 0:
        return ids.fill_(-1), vals.fill_(-1)
    lib = build.load()
    with torch.cuda.device(device):
        _, scratch_ints = compact_plan(n, q, cap)
        scratch = (torch.empty(scratch_ints, dtype=torch.int32, device=device)
                   if scratch_ints else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.repro_cpq_compact(
            counts.data_ptr(), threshold.data_ptr(), ids.data_ptr(), vals.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, q, cap, stream)
    common.check_status("cpq_compact", status)
    common.note_launch("cpq_compact")
    return ids, vals

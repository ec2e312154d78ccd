"""MINSUM match-count: the CUDA kernels' wrapper and its plain PyTorch version.

    counts[q, n] = sum_v min(data_cnt[n, v], query_cnt[q, v])     int32 [Q, N]

Replaces the TPU kernel `_minsum_kernel` / `minsum_count_pallas`
(`src/repro/kernels/minsum_count.py`), which does all Q*N*V minimums through a
third, accumulating grid axis over the vocabulary.  n-gram count vectors are
almost all zeros (a 40-letter title has at most 38 non-zero buckets of 4096),
so the kernels of `csrc/minsum_count.cu` (whose header says what bounds them
on an H100 and why the sum is exact for any int32 input) work on the data's
non-zero entries: per call, `minsum_nnz` counts each row's non-zero entries,
the wrapper turns the counts into row offsets (`torch.cumsum`) and sizes the
lists from their total, `minsum_csr` writes the (column, value) lists, and
`minsum_count` walks them against query rows staged in shared memory.  The
lists take two int32 words per non-zero entry (19 MB at DBLP's segment of
62,500 rows); they are scratch of the call, and the index keeps its dense
storage.  Where more than DENSE_ABOVE of the entries are non-zero the lists
would outweigh the data (a dense segment would double its bytes) and the
dense count tile (`minsum_count_dense`, the MinColumns policy of
`csrc/eq_tile.cuh`) is faster: the wrapper launches that instead of writing
the lists.  Each call notes one `minsum_count` launch, whichever count
kernel ran; the conversion's kernels are noted under their own names.

`minsum_count` launches the kernels for CUDA tensors and raises when it
cannot; it takes `minsum_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_minsum
from repro_torch.kernels import build, common

# The share of non-zero data entries above which the dense tile runs: the
# crossover of the two count paths on an H100 (chip_smoke.py phase 5d,
# PERF.md).
DENSE_ABOVE = 0.2

# The plain PyTorch version of this kernel is the engine's reference
# semantics, `core.match.match_minsum`, bound here under the kernel's name so
# the two stand side by side.
minsum_count_plain = match_minsum


def minsum_nnz_plain(data_cnt: torch.Tensor) -> torch.Tensor:
    """nnz int32 [N]: the non-zero entries of each row."""
    return (data_cnt != 0).sum(dim=1, dtype=torch.int32)


def minsum_csr_plain(data_cnt: torch.Tensor) -> torch.Tensor:
    """entries int32 [nnz, 2]: the (column, value) pairs of the non-zero
    entries, row by row, columns ascending."""
    rows, cols = (data_cnt != 0).nonzero(as_tuple=True)
    return torch.stack([cols.to(torch.int32), data_cnt[rows, cols].to(torch.int32)], dim=1)


def _stream(device: torch.device) -> int:
    """The current stream of the operands' device (not of the calling
    thread's current device)."""
    return torch.cuda.current_stream(device).cuda_stream


def minsum_nnz(data_cnt: torch.Tensor) -> torch.Tensor:
    """nnz int32 [N] of a checked int32 [N, V] (N, V >= 1): the first
    conversion kernel."""
    if data_cnt.device.type == "cpu":
        return minsum_nnz_plain(data_cnt)
    n, v = data_cnt.shape
    nnz = torch.empty(n, dtype=torch.int32, device=data_cnt.device)
    with torch.cuda.device(data_cnt.device):
        status = build.load().repro_minsum_nnz(data_cnt.data_ptr(), nnz.data_ptr(), n, v,
                                               _stream(data_cnt.device))
    common.check_status("minsum_nnz", status)
    common.note_launch("minsum_nnz")
    return nnz


def row_offsets(nnz: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(offsets int64 [N + 1], total): the exclusive prefix sum of the row
    counts, and its last entry read back to size the lists."""
    offsets = torch.zeros(nnz.shape[0] + 1, dtype=torch.int64, device=nnz.device)
    torch.cumsum(nnz, 0, out=offsets[1:])
    return offsets, int(offsets[-1])


def minsum_csr(data_cnt: torch.Tensor, offsets: torch.Tensor, total: int) -> torch.Tensor:
    """entries int32 [total, 2] of a checked int32 [N, V] (N, V >= 1) from
    its row offsets: the second conversion kernel."""
    if data_cnt.device.type == "cpu":
        return minsum_csr_plain(data_cnt)
    n, v = data_cnt.shape
    entries = torch.empty((total, 2), dtype=torch.int32, device=data_cnt.device)
    with torch.cuda.device(data_cnt.device):
        status = build.load().repro_minsum_csr(data_cnt.data_ptr(), offsets.data_ptr(),
                                               entries.data_ptr(), n, v, _stream(data_cnt.device))
    common.check_status("minsum_csr", status)
    common.note_launch("minsum_csr")
    return entries


def minsum_lists(data_cnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The data's non-zero entries as CSR lists: row offsets int64 [N + 1] and
    entries int32 [nnz, 2] of (column, value) in column order."""
    offsets, total = row_offsets(minsum_nnz(data_cnt))
    return offsets, minsum_csr(data_cnt, offsets, total)


def minsum_count_sparse(data_cnt: torch.Tensor, query_cnt: torch.Tensor,
                        lists: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """counts int32 [Q, N] by the count kernel over the lists
    (`minsum_lists(data_cnt)` unless given), whatever the density; Q, N, V
    >= 1.  `minsum_count` picks between this and the dense tile."""
    n, q, v = common.check_pair("minsum_count", data_cnt, query_cnt)
    if min(n, q, v) < 1:
        raise ValueError(f"minsum_count_sparse: empty operands (N, Q, V) = ({n}, {q}, {v})")
    offsets, entries = minsum_lists(data_cnt) if lists is None else lists
    out = torch.empty((q, n), dtype=torch.int32, device=data_cnt.device)
    with torch.cuda.device(data_cnt.device):
        status = build.load().repro_minsum_count(
            entries.data_ptr(), offsets.data_ptr(), query_cnt.data_ptr(), out.data_ptr(),
            n, q, v, _stream(data_cnt.device))
    common.check_status("minsum_count", status)
    common.note_launch("minsum_count")
    return out


def minsum_count_dense(data_cnt: torch.Tensor, query_cnt: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] by the dense tile, whatever the density."""
    n, q, v = common.check_pair("minsum_count", data_cnt, query_cnt)
    return common.launch_count("minsum_count", data_cnt, query_cnt, n, q, v,
                               entry="minsum_count_dense")


def minsum_count(data_cnt: torch.Tensor, query_cnt: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from count vectors int32 [N, V] and [Q, V], both
    contiguous and on one device."""
    if data_cnt.device.type == "cpu" and query_cnt.device.type == "cpu":
        return minsum_count_plain(data_cnt, query_cnt)
    n, q, v = common.check_pair("minsum_count", data_cnt, query_cnt)
    if min(n, q, v) >= 1:
        offsets, total = row_offsets(minsum_nnz(data_cnt))
        if total <= DENSE_ABOVE * n * v:
            lists = (offsets, minsum_csr(data_cnt, offsets, total))
            return minsum_count_sparse(data_cnt, query_cnt, lists)
    return minsum_count_dense(data_cnt, query_cnt)

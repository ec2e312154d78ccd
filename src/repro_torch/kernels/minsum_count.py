"""MINSUM match-count: the CUDA kernels' wrapper and its plain PyTorch version.

    counts[q, n] = sum_v min(data_cnt[n, v], query_cnt[q, v])     int32 [Q, N]

Replaces the TPU kernel `_minsum_kernel` / `minsum_count_pallas`
(`src/repro/kernels/minsum_count.py`), which does all Q*N*V minimums through a
third, accumulating grid axis over the vocabulary.  n-gram count vectors are
almost all zeros (a 40-letter title has at most 38 non-zero buckets of 4096),
so the kernels of `csrc/minsum_count.cu` (whose header says what bounds them
on an H100 and why the sum is exact for any int32 input) visit only the
(query, row) pairs that share a bucket, GENIE's inverted index.  Per call,
`minsum_nnz` counts the non-zero entries of each data row and of each query
row, the wrapper turns both counts into row offsets (`torch.cumsum`) and reads
the two totals and the widest data row back together (one read-back a call),
`minsum_csr` writes the (column, value) lists of both, and `minsum_count`
inverts chunks of the data's lists in shared memory and walks each query's
list against them.  The lists take two int32 words per non-zero entry (76 MB
at DBLP's part of 250,000 rows, 311 KB for 1024 queries); they are scratch of
the call, and the index keeps its dense storage.  Where more than DENSE_ABOVE
of the entries are non-zero the lists would outweigh the data (a dense segment
would double its bytes) and the dense count tile (`minsum_count_dense`, the
MinColumns policy of `csrc/eq_tile.cuh`) is faster: the wrapper launches that
instead of writing the lists, and also where a data row holds more non-zero
entries than a chunk's shared memory (`row_limit`, ~22,600 on an H100, so only
past that V).  Each call notes one `minsum_count` launch, whichever count
kernel ran, with the path as its variant ("inverted" or "dense"); the
conversion's kernels are noted under their own names.

`minsum_count` launches the kernels for CUDA tensors and raises when it
cannot; it takes `minsum_count_plain` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.match import match_minsum
from repro_torch.kernels import build, common

# The share of non-zero data entries above which the dense tile runs.  Against
# sparse queries the inverted walk is faster than the dense tile at every
# density of the data, 2.4x on a segment with no zero (chip_smoke.py phase 5d,
# PERF.md), so the share is conservative; it does not weigh the queries'
# density, and dense data against dense queries is not measured.
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


def row_offsets(*nnz: torch.Tensor) -> list[tuple[torch.Tensor, int, int]]:
    """(offsets int64 [N + 1], total, widest) of each row count int32 [N]
    (N >= 1): the exclusive prefix sum, its last entry and the largest
    count, read back together with the others' (one read-back for all)."""
    offsets = []
    for x in nnz:
        o = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
        torch.cumsum(x, 0, out=o[1:])
        offsets.append(o)
    back = torch.stack([o[-1] for o in offsets] + [x.max().to(torch.int64) for x in nnz])
    back = back.tolist()
    return list(zip(offsets, back[:len(nnz)], back[len(nnz):]))


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


def _lists(counts, sizes) -> list[tuple[torch.Tensor, torch.Tensor, int]]:
    """(offsets, entries, widest) of each count matrix from its sizes
    (`row_offsets`)."""
    return [(o, minsum_csr(x, o, total), widest) for x, (o, total, widest) in zip(counts, sizes)]


def minsum_lists(*counts: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor, int]]:
    """Each count matrix's non-zero entries as CSR lists: row offsets int64
    [N + 1], entries int32 [nnz, 2] of (column, value) in column order, and
    the most entries a row holds; their sizes read back together."""
    return _lists(counts, row_offsets(*(minsum_nnz(x) for x in counts)))


@functools.cache
def _row_limit(index: int) -> int:
    limit = ctypes.c_int()
    with torch.cuda.device(index):
        status = build.load().repro_minsum_count_row_limit(ctypes.byref(limit))
    common.check_status("minsum_count", status)
    return limit.value


def row_limit(device: torch.device) -> int:
    """The most non-zero entries a data row may hold for the inverted walk
    on a CUDA `device`: the entries one chunk keeps in a block's shared
    memory."""
    return _row_limit(torch.cuda.current_device() if device.index is None else device.index)


def minsum_count_sparse(data_cnt: torch.Tensor, query_cnt: torch.Tensor,
                        lists: list | None = None) -> torch.Tensor:
    """counts int32 [Q, N] by the inverted walk over the data's and the
    queries' lists (`minsum_lists(data_cnt, query_cnt)` unless given),
    whatever the density; Q, N, V >= 1, and no data row wider than
    `row_limit` (ValueError).  `minsum_count` picks between this and the
    dense tile."""
    n, q, v = common.check_pair("minsum_count", data_cnt, query_cnt)
    if min(n, q, v) < 1:
        raise ValueError(f"minsum_count_sparse: empty operands (N, Q, V) = ({n}, {q}, {v})")
    (offsets, entries, widest), (q_offsets, q_entries, _) = (
        minsum_lists(data_cnt, query_cnt) if lists is None else lists)
    limit = row_limit(data_cnt.device)
    if widest > limit:
        raise ValueError(f"minsum_count_sparse: a data row holds {widest} non-zero entries, "
                         f"past the inverted walk's {limit}; minsum_count takes the dense tile")
    out = torch.empty((q, n), dtype=torch.int32, device=data_cnt.device)
    with torch.cuda.device(data_cnt.device):
        status = build.load().repro_minsum_count(
            entries.data_ptr(), offsets.data_ptr(), q_entries.data_ptr(), q_offsets.data_ptr(),
            out.data_ptr(), n, q, v, widest, _stream(data_cnt.device))
    common.check_status("minsum_count", status)
    common.note_launch("minsum_count", "inverted")
    return out


def minsum_count_dense(data_cnt: torch.Tensor, query_cnt: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] by the dense tile, whatever the density."""
    n, q, v = common.check_pair("minsum_count", data_cnt, query_cnt)
    return common.launch_count("minsum_count", data_cnt, query_cnt, n, q, v,
                               entry="minsum_count_dense", variant="dense")


def minsum_count(data_cnt: torch.Tensor, query_cnt: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from count vectors int32 [N, V] and [Q, V], both
    contiguous and on one device."""
    if data_cnt.device.type == "cpu" and query_cnt.device.type == "cpu":
        return minsum_count_plain(data_cnt, query_cnt)
    n, q, v = common.check_pair("minsum_count", data_cnt, query_cnt)
    if min(n, q, v) >= 1:
        counts = (data_cnt, query_cnt)
        sizes = row_offsets(*(minsum_nnz(x) for x in counts))
        (_, total, widest), _ = sizes
        if total <= DENSE_ABOVE * n * v and widest <= row_limit(data_cnt.device):
            return minsum_count_sparse(data_cnt, query_cnt, _lists(counts, sizes))
    return minsum_count_dense(data_cnt, query_cnt)
